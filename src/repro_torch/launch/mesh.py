"""Meshes of ``torch.distributed`` ranks, and the worlds that hold them.

Port of ``repro/launch/mesh.py``.  ``make_local_mesh`` and ``make_fl_mesh``
return a ``("data", "model")`` grid of ranks of shape ``(n, 1)``: the
engine's selected-client axis and the production step's clients run over
``"data"``; ``"model"`` stays size 1, because every rank holds the whole
model.  ``make_production_mesh`` is the logical (16, 16) or (2, 16, 16)
mesh of the dry run: it has no process group and nothing executes on it.
:class:`HW` holds the H100's data-sheet figures that the dry run's
roofline and ``chip_smoke.py``'s bounds read.

:class:`FLMesh` is not torch's ``DeviceMesh``: ``init_device_mesh``
creates its sub-groups with the backend's default timeout (half an hour
for gloo), and a second group for the world when the world is gloo and a
card is visible.  Every process group here is created with
:data:`PG_TIMEOUT`, a minute, so a rank that fails cannot hold the others
for longer; the mesh's one group is the world.

:func:`run_world` starts ``n`` ranks itself (the spawn start method, a
``FileStore`` rendezvous in a fresh temporary directory) for a caller
that has no process group.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["FLMesh", "HW", "PG_TIMEOUT", "make_production_mesh", "make_local_mesh",
           "make_fl_mesh", "ranks_available", "run_world"]

#: the timeout of every process group this package creates: a collective
#: that waits longer on a rank raises instead of hanging the world
PG_TIMEOUT = datetime.timedelta(seconds=60)


class FLMesh:
    """A grid of ranks with named axes.  ``group`` is the process group of
    the ranks along ``"data"`` (the world), or ``None`` on one rank."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], group=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.mesh_dim_names: Tuple[str, ...] = tuple(axes)
        self.group = group

    @property
    def chips(self) -> int:
        """Devices in the grid."""
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        """Ranks along ``axis``."""
        return self.shape[self.mesh_dim_names.index(axis)]

    def get_group(self, axis: str = "data"):
        """The process group of ``axis``; None where it has one rank."""
        return self.group if self.size(axis) > 1 else None

    def get_local_rank(self, axis: str = "data") -> int:
        group = self.get_group(axis)
        return dist.get_rank(group) if group is not None else 0


class HW:
    """One NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no
    sparsity, at the full 700 W power limit): the roofline of the dry run
    and the bounds of ``chip_smoke.py``.  ``NVLINK_BW`` is NVLink 4's
    900 GB/s a card split into its two directions; past one 8-card node a
    mesh's links are the network's, slower, so the collective term it
    gives is a lower bound there."""

    PEAK_FLOPS_BF16 = 989e12       # dense BF16 on the tensor cores, per card
    PEAK_FLOPS_TF32 = 495e12       # dense TF32 on the tensor cores
    PEAK_FLOPS_FP32 = 67e12        # FP32 on the CUDA cores
    HBM_BW = 3.35e12               # HBM3 bytes/s per card
    NVLINK_BW = 450e9              # bytes/s per direction per card
    HBM_BYTES = 80e9               # 80 GB of HBM3 per card


def make_production_mesh(*, multi_pod: bool = False) -> FLMesh:
    """The dry run's logical mesh: ``(data=16, model=16)``, or ``(pod=2,
    data=16, model=16)``.  It has no process group; nothing executes on
    it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return FLMesh(shape, axes)


def ranks_available(backend: str) -> int:
    """How many ranks of ``backend`` this host can place: NCCL one a card,
    gloo one a CPU core."""
    if backend == "nccl":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def make_local_mesh(shape: Sequence[int] = (1, 1),
                    axes: Sequence[str] = ("data", "model")) -> FLMesh:
    """A mesh over the ranks that exist: one rank needs no process group;
    more must be exactly the initialized world."""
    n = math.prod(shape)
    if n == 1:
        return FLMesh(shape, axes)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"mesh {tuple(shape)} wants {n} ranks but no process group is "
                         "initialized (run_fl starts one; or use torchrun)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} wants {n} ranks but the world has {world}")
    return FLMesh(shape, axes, dist.group.WORLD)


def make_fl_mesh(n_devices: int) -> FLMesh:
    """Mesh for the sharded fused FL round (``fl/engine.py``): ``(n, 1)``
    over ``("data", "model")``.  Raises ``ValueError`` where the world is
    not ``n_devices`` ranks, or where its backend cannot place them (NCCL:
    one rank a card)."""
    n_devices = int(n_devices)
    if n_devices > 1 and dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        if backend == "nccl" and n_devices > ranks_available("nccl"):
            raise ValueError(f"mesh wants {n_devices} NCCL ranks but only "
                             f"{ranks_available('nccl')} cards exist")
    return make_local_mesh((n_devices, 1), ("data", "model"))


def _rank_main(rank: int, fn: Callable, n: int, backend: str, tmp: str, threads: int,
               args: tuple) -> None:
    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n, timeout=PG_TIMEOUT)
    # a rank that raises leaves the group as it is: the parent kills the
    # others, and a teardown could wait on a peer inside a collective
    out = fn(rank, *args)
    dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def run_world(fn: Callable[..., Any], n: int, backend: str, args: tuple = ()) -> List[Any]:
    """Start ``n`` ranks, each a spawned process in a ``backend`` process
    group of ``n`` (NCCL: rank r on card r), call ``fn(rank, *args)`` in
    each and return their results in rank order.  ``fn`` is pickled by
    reference, so it is a module-level function; ``args`` and the results
    by value.  A rank
    that raises makes this raise ``torch.multiprocessing.ProcessRaisedException``
    with its traceback; the other ranks are killed and reaped.  The ranks
    keep this process's thread count."""
    if n > ranks_available(backend):
        raise ValueError(f"{n} {backend} ranks wanted but this host places "
                         f"{ranks_available(backend)}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, backend, tmp, torch.get_num_threads(), args), nprocs=n,
            join=True, start_method="spawn")
        out = []
        for rank in range(n):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))       # written by this world's ranks
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

