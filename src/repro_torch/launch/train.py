"""Federated training driver.

Port of ``repro/launch/train.py``: its flags, plus ``--device`` (``cuda``
unless the caller asks for ``cpu``).

  * ``--mode sim`` (default): the benchmark-scale FL loop
    (``repro_torch.fl``) -- real learning on the synthetic LM task with
    exact uplink accounting, on the fused engine, the reference's
    ``FLConfig`` default (the port's ``FLConfig`` defaults to the loop).
    It accepts ``--arch``, ``--batch`` and ``--seq`` and ignores them, as
    the reference's does.

  * ``--mode spmd``: the production round step (``launch/steps.py``) on a
    local mesh ``(1, 1)`` of this process's device, with ``--arch``'s
    reduced config (vocab 256): one client, an eval loss after every round
    (the flash kernel on the card).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode sim --method gradestc --rounds 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 3 --clients 2
  PYTHONPATH=src python -m repro_torch.launch.train --mode spmd --arch gemma3-1b --rounds 3
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def _run_sim(args) -> int:
    from repro_torch.fl.simulation import FLConfig, run_fl

    cfg = FLConfig(
        method=args.method,
        rounds=args.rounds,
        n_clients=args.clients,
        local_steps=args.local_steps,
        alpha=args.alpha,
        lr=args.lr,
        seed=args.seed,
        eval_every=max(1, args.rounds // 10),
        engine="fused",
        device=args.device,
    )

    def progress(rnd, info):
        print(f"round {rnd:4d} loss={info['loss']:.4f} acc={info['acc']:.4f} "
              f"uplink={info['uplink']/2**20:.2f}MiB", flush=True)

    res = run_fl(cfg, progress=progress)
    print("---")
    print(res.ledger.summary())
    print(f"final loss {res.eval_loss[-1]:.4f}  acc {res.eval_acc[-1]:.4f}  "
          f"wall {res.wall_s:.1f}s")
    return 0


def _run_spmd(args) -> int:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data import client_batch_stream, make_task
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import make_plan
    from repro_torch.launch.steps import (compression_policy_for, make_fl_round_step,
                                          make_ge_state)
    from repro_torch.models import model

    cfg = dataclasses.replace(get_config(args.arch).reduced(), vocab=256)
    dev = torch.device(args.device)
    # the process drives one device, as the reference does on one host
    # device; a world of ranks takes a GEState built once in its caller
    # (``launch/steps.make_fl_round_step``)
    mesh = make_local_mesh((1, 1), ("data", "model"))
    plan = make_plan(mesh, cfg)
    policy = compression_policy_for(cfg, plan)
    C = plan.n_clients

    step = make_fl_round_step(cfg, mesh, plan, policy, method=args.method,
                              lr=args.lr, local_steps=args.local_steps)
    params = model.init_params(cfg, prng.PRNGKey(args.seed, dev))
    ge_state = make_ge_state(cfg, policy, C, seed=args.seed, device=dev)

    task = make_task(vocab=cfg.vocab, n_clients=C, alpha=args.alpha, seed=args.seed)
    streams = [client_batch_stream(task, c, args.batch, args.seq, args.seed)
               for c in range(C)]
    evalb = {k: torch.from_numpy(v).to(dev)
             for k, v in next(client_batch_stream(task, -1, args.batch, args.seq, 77)).items()}

    for rnd in range(args.rounds):
        t0 = time.time()
        bs = [next(s) for s in streams]
        batches = {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(dev) for k in bs[0]}
        params, ge_state, _ = step(params, ge_state, batches)
        with torch.no_grad():
            l = float(model.loss_fn(cfg, params, evalb))
        print(f"round {rnd}: eval_loss={l:.4f}  ({time.time()-t0:.1f}s)", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["sim", "spmd"], default="sim")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--method", default="gradestc")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--local-steps", dest="local_steps", type=int, default=2)
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet non-IID (0.5/0.1); default IID")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compilation-cache", default=None, metavar="DIR",
                    help="the CUDA kernels' build directory (default: "
                    "build/repro_torch_kernels under the repository root)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    # host knobs first, before the first torch import (the build cache's)
    from repro_torch.launch.env import configure_host

    configure_host(verbose=True)
    # the kernels' build cache: a later run loads the library it built
    from repro_torch.launch.compile_cache import enable_compilation_cache

    enable_compilation_cache(args.compilation_cache)
    if args.mode == "sim":
        return _run_sim(args)
    return _run_spmd(args)


if __name__ == "__main__":
    raise SystemExit(main())
