"""Loss curves of ``Trainer.run`` on smollm-135m at full width, on the
synthetic corpus, for several runs side by side.

    python tools/train_probe.py [--vocab V] [--steps N] RUN [RUN ...]

Each RUN is ``device:dtype:mlp:layers[:steps]``, for example
``cuda:bfloat16:glu-kernel:30`` or ``cpu:float32:dense:30:3``: the
device, the params' dtype, the MLP (``glu-kernel``: the silu GLU under
``mode="kernel"``, the gated GEMM in FP, BP and WG; ``relu-fused``: the
relu MLP under ``mode="fused"``; ``dense``: the silu GLU, sparsity off)
and the depth; widths are the published ones. Every run starts from the
same seeded init (the same values in each dtype) and sees the same
batches, ``chip_smoke.train_data``'s 8 x 512 tokens drawn from the
first V token ids (all of them by default), and AdamW at lr 1e-3 as in
``chip_smoke.run_training``. One JSON line per run (its losses, the mean
of the first and last 5, ln V, ms per step after the first), then, for
each later run, the largest difference of its losses from the first
run's over the steps both took. The card's name and power limit come
first when a card is used.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLPS = {"glu-kernel": ("silu", dict(enabled=True, mode="kernel")),
        "relu-fused": ("relu", dict(enabled=True, mode="fused")),
        "dense": ("silu", dict(enabled=False))}


def run_one(spec, vocab, steps):
    import torch
    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    fields = spec.split(":")
    device, dtype, mlp, layers = fields[:4]
    steps = int(fields[4]) if len(fields) > 4 else steps
    act, sparsity = MLPS[mlp]
    cfg = cs.train_config(act, sparsity, num_layers=int(layers),
                          dtype=dtype)
    shape = ShapeConfig("probe", cs.TRAIN["seq"], cs.TRAIN["batch"], "train")
    tr = Trainer(cfg, shape, AdamW(lr=1e-3),
                 TrainConfig(steps=steps, log_every=1, seed=cs.TRAIN["seed"]),
                 device=device)
    res = tr.run(cs.train_data(vocab=vocab))
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    hist = [h for h in res["history"] if "loss" in h]
    losses = [h["loss"] for h in hist]
    dts = [h["dt"] for h in hist[1:]]
    return {"run": spec, "vocab": vocab, "ln_vocab": math.log(vocab),
            "losses": losses, "first5": sum(losses[:5]) / len(losses[:5]),
            "last5": sum(losses[-5:]) / len(losses[-5:]),
            "ms_per_step": 1e3 * sum(dts) / len(dts) if dts else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=None,
                    help="token ids drawn below this (default: all)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke as cs
    if any(r.startswith("cuda") for r in args.runs):
        assert torch.cuda.is_available(), "a cuda run needs a CUDA device"
        torch.backends.cuda.matmul.allow_tf32 = False
        print(cs.gpu_name_and_power(), flush=True)
    vocab = args.vocab or cs.arch_config().vocab_size
    out = []
    for spec in args.runs:
        t0 = time.perf_counter()
        r = run_one(spec, vocab, args.steps)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        out.append(r)
    base = out[0]
    for r in out[1:]:
        n = min(len(r["losses"]), len(base["losses"]))
        diff = max(abs(a - b) for a, b in zip(r["losses"][:n],
                                              base["losses"][:n]))
        print(json.dumps({"run": r["run"], "against": base["run"],
                          "steps": n, "max_abs_loss_diff": diff}),
              flush=True)


if __name__ == "__main__":
    main()
