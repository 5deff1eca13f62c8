"""Decode ms per tick of the PyTorch port's engine under its MLP paths,
served in turns in one process on one GPU.

    PYTHONPATH=src python tools/torch_serve_ab.py [--rounds 3]

Variants: the gated-GLU MLP through its fused kernel (block_m 64, the
default config's path), and the relu MLP of the launcher's ``--sparce``
(block_m 1, block_k 128) in ``mode="fused"`` and ``mode="kernel"``.
Trace: smollm-135m at full width in bf16 with seeded random weights, 16
requests with prompts of 16-256 tokens and budgets drawn from [8, 32]
(the launcher's ``--mixed`` rule), 8 slots, max_len 512, 16-row KV
blocks, the paged attention kernel. Each round serves every variant once,
in an order rotated by one per round, since the host's load drifts
during a run; the script prints every run and the median per variant,
beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import time

import numpy as np
import torch


def requests(cfg, n=16, seed=0):
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(seed)
    budgets = np.random.default_rng(seed + 1).integers(8, 33, n)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(16, 257))),
        max_new=int(budgets[i])) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.core.sparse_ops import SparsityConfig
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.server import ServeConfig, Server

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    glu_cfg = get_config("smollm-135m")
    relu_cfg = dataclasses.replace(glu_cfg, mlp_act="relu")
    params = {"silu": model_lib.init_params(glu_cfg, seed=0, device="cuda"),
              "relu": model_lib.init_params(relu_cfg, seed=0, device="cuda")}
    variants = {
        "glu fused": (glu_cfg, SparsityConfig(enabled=True, mode="fused")),
        "relu fused": (relu_cfg, SparsityConfig(
            enabled=True, mode="fused", block_m=1, block_k=128)),
        "relu kernel": (relu_cfg, SparsityConfig(
            enabled=True, mode="kernel", block_m=1, block_k=128)),
    }
    names = list(variants)
    ms = {n: [] for n in names}
    for rnd in range(-1, args.rounds):  # round -1 warms up every path
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for name in order:
            cfg, sp = variants[name]
            srv = Server(cfg, params[cfg.mlp_act], ServeConfig(
                batch_slots=8, max_len=512, kv_block_size=16,
                attn_kernel="paged", sparsity=sp), device="cuda")
            t0 = time.perf_counter()
            srv.generate(requests(cfg))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = srv.metrics
            if rnd < 0:
                continue
            ms[name].append(1e3 * m.decode_s / m.ticks)
            print(f"round {rnd} {name}: {ms[name][-1]:.3f} ms/tick "
                  f"({int(m.ticks)} ticks, "
                  f"{m.decode_tokens / m.decode_s:.1f} decode tokens/s), "
                  f"prefill {m.prefill_s:.3f}s, wall {wall:.3f}s, "
                  f"mlp_skip_fraction {m.mlp_skip_fraction:.4f}")
    for name in names:
        print(f"median {name}: {statistics.median(ms[name]):.3f} ms/tick "
              f"over {len(ms[name])} runs")


if __name__ == "__main__":
    main()
