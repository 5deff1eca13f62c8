"""Training launcher (single host).

    python -m repro_torch.launch.train --arch smollm-135m --reduced \
        --steps 5 [--device cpu] [--ckpt-dir DIR] [--remat full|dots]

The reference launcher's flags. ``--mesh`` and ``--zero1`` raise
NotImplementedError (multi-device is not ported yet); ``--device``
defaults to ``cuda``. Batches come from the seeded synthetic corpus.
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
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch_iterator
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    if args.mesh:
        raise NotImplementedError(
            "--mesh (sharded training) not ported yet; the port trains on "
            "one device")
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
    trainer = Trainer(cfg, shape, opt, tc, device=args.device)
    it = make_batch_iterator(cfg, shape, DataConfig(seed=args.seed))

    def log(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:6d} loss {float(metrics['loss']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)

    out = trainer.run(it, metrics_cb=log)
    print(f"done: {out['final_step']} steps, "
          f"{len(out['straggler_events'])} straggler events")
    return out


if __name__ == "__main__":
    main()
