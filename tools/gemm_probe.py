"""Device times of the gated and compacted SparCE GEMM kernels on one GPU
against their chunk size, dtype and live fraction, beside ``x @ w``.

    PYTHONPATH=src python tools/gemm_probe.py

For each AlexNet shape the phase-7 plans give these kernels (conv2 lhs
gated, conv4 and fc6 lhs compacted, deepcomp conv4 rhs gated) it times
the kernel at the wrapper's chunk size S and at other S (the chunks
stay fixed per call, so any S gives a valid product), in f32 and bf16,
with random bits at the layer's live fraction and with every tile live,
and ``x @ w`` in the same dtype. Times are ``chip_smoke.device_time_ms``:
the device time of the kernels by name from ``torch.profiler``, summed
over both passes of a split-K call, per call.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import GEMM_KERNELS, device_time_ms  # noqa: E402
from repro_torch.kernels import sparce_gemm as sg  # noqa: E402

# (label, M, K, N, bm, bk, bn, gate, kernel, live fraction of the bits)
SHAPES = (
    ("alexnet/conv2", 729, 2400, 256, 8, 128, 256, "lhs", "gated", 0.61),
    ("alexnet/conv4", 169, 3456, 384, 8, 128, 256, "lhs", "compacted", 0.38),
    ("alexnet/fc6", 1, 9216, 4096, 8, 128, 256, "lhs", "compacted", 0.35),
    ("deepcomp/conv4", 169, 3456, 384, 168, 128, 128, "rhs", "gated", 0.37),
)


def main():
    assert torch.cuda.is_available(), "needs a CUDA device"
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return probe(torch.device("cuda"), sg.chunk_tiles)


def probe(dev, default_tiles):
    rows = []
    for label, M, K, N, bm, bk, bn, gate, kind, live in SHAPES:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
        grid = sg.bit_grid(M, K, N, block_m=bm, block_k=bk, block_n=bn,
                           gate=gate)
        gk = -(-K // bk)
        s0 = default_tiles(K, bk)
        for bits_kind in ("plan", "all live"):
            bits = (rng.random(grid) >= live if bits_kind == "plan"
                    else np.zeros(grid, bool)).astype(np.int32)
            bt = torch.from_numpy(bits).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                xt, wt = x.to(dev, dtype), w.to(dev, dtype)
                kw = dict(block_m=bm, block_k=bk, block_n=bn)
                if kind == "gated":
                    run = lambda: sg.sparce_gemm_gated(  # noqa: E731
                        xt, wt, bt, gate=gate, **kw)
                else:
                    run = lambda: sg.sparce_gemm_compacted(  # noqa: E731
                        xt, wt, bt, **kw)
                lib, _ = device_time_ms(lambda: xt @ wt)
                plain = (sg.sparce_gemm_gated_plain(xt, wt, bt, gate=gate,
                                                    **kw) if kind == "gated"
                         else sg.sparce_gemm_compacted_plain(xt, wt, bt,
                                                             **kw))
                err = float((run().float() - plain.float()).abs().max())
                for s in sorted({1, s0, 2 * s0, gk}):
                    sg.chunk_tiles = lambda k, b, s=s: s  # noqa: E731
                    try:
                        ms, _ = device_time_ms(run, names=GEMM_KERNELS)
                    finally:
                        sg.chunk_tiles = default_tiles
                    row = dict(shape=label, kernel=kind,
                               bits=bits_kind,
                               dtype=str(dtype)[6:], S=s, chunks=-(-gk // s),
                               default_S=s == s0, ms=round(ms, 5),
                               x_at_w_ms=round(lib, 5), max_abs_err=err)
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
