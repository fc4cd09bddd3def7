"""Federated training driver.

Port of ``repro/launch/train.py``: the flags of its sim mode, plus
``--device`` (``cuda`` unless the caller asks for ``cpu``).

  * ``--mode sim`` (default): the benchmark-scale FL loop
    (``repro_torch.fl``) -- real learning on the synthetic LM task with
    exact uplink accounting, on the fused engine, the reference's
    ``FLConfig`` default (the port's ``FLConfig`` defaults to the loop).

  * ``--mode spmd``: the production SPMD round step is not ported
    (``launch/steps.py``, ROADMAP A13); it raises ``NotImplementedError``.
    Its flags, ``--arch``, ``--batch`` and ``--seq``, which sim mode does not
    read, come with it.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode sim --method gradestc --rounds 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 3 --clients 2
"""

from __future__ import annotations

import argparse


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
    raise NotImplementedError(
        "--mode spmd runs the production SPMD round step (the reference's "
        "launch/steps.py), which the port does not have yet (ROADMAP A13); "
        "use --mode sim")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["sim", "spmd"], default="sim")
    ap.add_argument("--method", default="gradestc")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--local-steps", dest="local_steps", type=int, default=2)
    ap.add_argument("--alpha", type=float, default=None,
                    help="Dirichlet non-IID (0.5/0.1); default IID")
    ap.add_argument("--lr", type=float, default=0.05)
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
