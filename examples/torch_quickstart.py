"""Quickstart of the PyTorch/CUDA port: the paper's technique in one file.

1. A sparse-activation GEMM skipped tile by tile (SpRF bitmap + SASA
   plan + the skipping CUDA kernel) vs its dense baseline.
2. A tiny ReLU LM trained with SparCE-gated MLPs (the transform is
   lossless, so the loss falls as a dense model's does).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On a CUDA device the kernels launch, and the skipping GEMM's time is
printed beside ``x @ w``'s (CUDA events); on the CPU every kernel runs
its plain PyTorch version.
"""
import argparse
import dataclasses
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import sasa, sprf
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.data.pipeline import DataConfig, make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.trainer import TrainConfig, Trainer


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gemm_section(dev: torch.device) -> None:
    print("== SparCE gated GEMM ==")
    M, K, N = 512, 2048, 512
    # Features out of a ReLU layer: ~60% zeros, clustered in rows.
    x = sprf.random_sparse(torch.Generator(device=dev).manual_seed(0),
                           (M, K), 0.6, cluster=(8, 128))
    w = torch.randn((K, N), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev) * 0.02

    # SASA-style static analysis chooses gating operand + tile shapes.
    plan = sasa.plan_matmul(M, K, N, lhs_sparsity=0.6, lhs_cluster=8 * 128)
    print(f"plan: gate={plan.gate} variant={plan.variant} "
          f"blocks={plan.block_m}x{plan.block_k}x{plan.block_n}")

    # SpRF-style bitmap (produced fused into the ReLU in the full stack).
    bitmap = sprf.compute_bitmap(x, plan.block_lhs)
    frac = float(bitmap.sparsity())
    print(f"tile-level sparsity: {frac:.1%} ({int(bitmap.num_skipped())} "
          f"of {bitmap.grid[0] * bitmap.grid[1]} x tiles skipped)")

    y_sparce = kops.sparce_gemm(x, w, plan, lhs_bitmap=bitmap)
    y_dense = x @ w
    err = float((y_sparce - y_dense).abs().max())
    print(f"max |sparce - dense| = {err:.2e}  (f32 sums over the live "
          "tiles only, in another order)")
    # The skipped tiles' share of the GEMM's bytes (x, w and y once
    # each): the w stripes a dead x tile never fetches.
    skipped = K * N * frac / (M * K + K * N + M * N)
    print(f"modeled bytes skipped: {skipped:.1%}")
    if dev.type == "cuda":
        ms = cuda_ms(lambda: kops.sparce_gemm(x, w, plan, lhs_bitmap=bitmap))
        ms_dense = cuda_ms(lambda: x @ w)
        print(f"on {torch.cuda.get_device_name(dev)}: skipping GEMM "
              f"{ms:.4f} ms, x @ w {ms_dense:.4f} ms (CUDA events)")
    print()


def lm_section(dev: torch.device) -> None:
    print("== tiny ReLU LM with SparCE-gated MLPs ==")
    cfg = dataclasses.replace(
        get_config("smollm-135m").reduced(),
        mlp_act="relu",  # the paper's sparsity source
        sparsity=SparsityConfig(enabled=True, mode="reference"),
    )
    shape = ShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")
    trainer = Trainer(cfg, shape, AdamW(lr=3e-3, weight_decay=0.0),
                      TrainConfig(steps=30, log_every=10), device=dev)
    out = trainer.run(make_batch_iterator(cfg, shape,
                                          DataConfig(noise=0.05)))
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          "steps")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    gemm_section(dev)
    lm_section(dev)
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
