#!/usr/bin/env python3
"""What one psum costs on a serving mesh whose ranks share one card.

    python3 tools/mesh_collective_probe.py [--iters 200]

Spawns meshes of 1 x 2 and 1 x 3 ranks (every rank on card 0, gloo, as
``chip_smoke.py`` phase 13 runs them) and times, per call, a gloo
all-reduce of the decode tick's residual partial (8 x 1 x 576 bf16):
on a CPU tensor, on a CUDA tensor with nothing queued before it, and on
a CUDA tensor right after a small matmul (as in the model, where every
psum waits for the layer's work); then the same meshes with ranks that
never touch the card (CPU tensors only). Each rank's mean ms per call
is printed beside the card's name and power limit. Needs the card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def probe(mesh, iters, cuda):
    import torch
    from repro_torch.parallel import collectives

    out = {}
    x_cpu = torch.ones(8, 1, 576, dtype=torch.bfloat16)
    cases = [("cpu tensor", lambda: collectives.psum(x_cpu.clone(),
                                                    "model"))]
    if cuda:
        dev = torch.device("cuda", 0)
        x_dev = x_cpu.to(dev)
        a = torch.randn(8, 576, device=dev, dtype=torch.bfloat16)
        w = torch.randn(576, 576, device=dev, dtype=torch.bfloat16)
        cases += [
            ("cuda tensor", lambda: collectives.psum(x_dev.clone(), "model")),
            ("cuda tensor after a matmul",
             lambda: collectives.psum((a @ w).reshape(8, 1, 576), "model"))]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for label, fn in cases:
        for _ in range(10):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        out[label] = 1e3 * (time.perf_counter() - t0) / iters
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mesh_collective_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn_mesh
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for cuda in (True, False):
        for shape in ((1, 2), (1, 3)):
            outs = spawn_mesh(probe, shape, (args.iters, cuda),
                              device="cuda:0" if cuda else "cpu",
                              backend="gloo", timeout_s=60.0,
                              deadline_s=300.0)
            where = "ranks on card 0" if cuda else "CPU-only ranks"
            for rank, res in enumerate(outs):
                print(f"mesh {shape} ({where}) rank {rank}: " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
