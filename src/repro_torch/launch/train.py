"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-135m --reduced \
        --steps 5 [--device cpu] [--ckpt-dir DIR] [--remat full|dots] \
        [--mesh D,M | P,D,M [--zero1] [--backend gloo|nccl]
         [--mesh-timeout 60]]

The reference launcher's flags; ``--device`` defaults to ``cuda``.
Batches come from the seeded synthetic corpus.

``--mesh`` trains on a mesh of one process per rank
(``launch/mesh.py:spawn_mesh``) over the axes
``("pod", "data", "model")[-len(dims):]``, as the reference launcher
names them (``--mesh 4`` is a model-only mesh). ``--backend gloo`` puts
every rank on ``--device`` (card 0 for ``cuda``), ``nccl`` rank r on
card r. Rank 0 prints the single host's step lines, plus one ``mesh:``
line with each collective kind's calls, operand bytes and seconds;
``--mesh-timeout`` bounds every collective's wait, in seconds.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default=None, help="e.g. '16,16' or '2,16,16'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"])
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="--mesh collectives: 'gloo' (every rank on "
                         "--device) or 'nccl' (rank r on card r)")
    ap.add_argument("--mesh-timeout", type=float, default=60.0,
                    help="--mesh: seconds any collective may wait")
    args = ap.parse_args(argv)
    if args.mesh is None:
        return train(args)
    from repro_torch.launch.mesh import spawn_mesh

    dims = tuple(int(x) for x in args.mesh.split(","))
    n = 1
    for d in dims:
        n *= d
    if args.backend == "nccl":
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = ["cuda:0" if args.device == "cuda" else args.device] * n
    outs = spawn_mesh(train_rank, dims, (args,), device=devices,
                      backend=args.backend, timeout_s=args.mesh_timeout,
                      axes=("pod", "data", "model")[-len(dims):])
    return outs[0]


def train_rank(mesh, args):
    """One rank of ``--mesh``: :func:`train` on this rank's device; rank
    0 prints. Returns rank 0's summary (the others': None)."""
    import torch

    device = args.device
    if device.startswith("cuda"):
        device = f"cuda:{torch.cuda.current_device()}"
    out = train(args, mesh=mesh, device=device, quiet=mesh.rank != 0)
    if mesh.rank != 0:
        return None
    return {k: out[k] for k in ("history", "final_step", "straggler_events")}


def train(args, mesh=None, device=None, quiet: bool = False):
    """Train as the flags say, on one device or on this rank of
    ``mesh``; prints the step lines unless ``quiet``."""

    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch_iterator
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)

    shape = shape_by_name(args.shape)
    if args.seq_len or args.global_batch:
        shape = ShapeConfig(
            "custom", args.seq_len or shape.seq_len,
            args.global_batch or shape.global_batch, "train")

    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    tc = TrainConfig(
        steps=args.steps, log_every=args.log_every,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        zero1=args.zero1, seed=args.seed,
    )
    trainer = Trainer(cfg, shape, opt, tc, mesh=mesh,
                      device=device or args.device)
    it = make_batch_iterator(cfg, shape, DataConfig(seed=args.seed))

    def log(step, metrics):
        if step % args.log_every == 0 and not quiet:
            print(f"step {step:6d} loss {float(metrics['loss']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)

    out = trainer.run(it, metrics_cb=log)
    if not quiet:
        print(f"done: {out['final_step']} steps, "
              f"{len(out['straggler_events'])} straggler events")
    if mesh is not None and not quiet:
        from repro_torch.parallel import collectives

        st = collectives.stats(mesh)
        kinds = " ".join(
            f"{k}={st['counts'][k]}/{st[k]}B/{st['seconds'][k]:.3f}s"
            for k in collectives.KINDS if st["counts"][k])
        print(f"mesh: {dict(mesh.shape)} calls/bytes/seconds {kinds}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
