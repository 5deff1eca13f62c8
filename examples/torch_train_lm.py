"""End-to-end training example on the PyTorch/CUDA port: train a
~100M-class LM.

Default invocation trains the REAL smollm-135m architecture (135M
params) on the synthetic corpus, with checkpointing and fault-tolerant
restart:

    PYTHONPATH=src python examples/torch_train_lm.py            # 25 steps
    PYTHONPATH=src python examples/torch_train_lm.py --fast     # 2 layers
    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --fast --device cpu

The checkpoints go to ``<tmp>/repro_torch_train_lm_<mode>_<steps>``
unless ``--ckpt-dir`` says otherwise; a second run with the same flags
resumes from them. On several cards the launcher it wraps
(``repro_torch/launch/train.py``) takes ``--mesh``.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        mode = "fast" if args.fast else "full"
        args.ckpt_dir = os.path.join(
            tempfile.gettempdir(),
            f"repro_torch_train_lm_{mode}_{args.steps}")

    flags = [
        "--arch", "smollm-135m",
        "--steps", str(args.steps),
        "--seq-len", "64",
        "--global-batch", "2",
        "--lr", "1e-3",
        "--warmup", "10",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "10",
        "--log-every", "1",
        "--device", str(resolve_device(args.device)),
    ]
    if args.fast:
        flags.append("--reduced")
    out = train_launch.main(flags)
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    if not losses:
        print("resumed past target step; nothing to train")
        return 0
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
