"""What sets the relu_bitmap kernel's launch floor, on one GPU.

    python tools/relu_bitmap_probe.py

Builds variants of ``src/repro_torch/csrc/relu_bitmap.cu`` (the source
as it is, and copies edited as text, compiled with the port's nvcc
flags into ``build/probe/``, one nvcc each, all at once):

- ``kept``: the source as it is (128 threads a CTA);
- ``threads256``: 256 threads a CTA;
- ``empty`` and ``empty256``: the same launches with a kernel that
  returns at once (the floor of the grid alone).

Each runs at the relu decode tick's h (8 x 1536), a 256-row prefill
(256 x 1536) and one (1, 128) tile, bf16, tile (1, 128), on two grids:
``rule`` (the tiles one 16-byte vector a thread covers, as
``relu_bitmap_grid`` picks for the variant's threads) and ``one_tile``
(one tile a CTA, the first design's grid). It prints, per case, the
kernel's registers (ptxas), CTAs, the device time from ``torch.profiler``
(``chip_smoke.device_time_ms``) and from a replayed CUDA graph
(``chip_smoke.graph_time_ms``), and whether ``y`` and the bits equal the
plain version's bit for bit (not checked for the empty kernels). The
cases run twice, the second time in the reverse order. One JSON line per
case, after the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe")
KEPT_THREADS = "constexpr int RB_THREADS = 128;"
BODY = "  constexpr int V = 16 / sizeof(T);\n  extern __shared__ int flag_s[];"
VARIANTS = {
    "kept": (128, []),
    "threads256": (256, [(KEPT_THREADS, "constexpr int RB_THREADS = 256;")]),
    "empty": (128, [(BODY, "  if (R > 0) return;\n" + BODY)]),
    "empty256": (256, [(KEPT_THREADS, "constexpr int RB_THREADS = 256;"),
                       (BODY, "  if (R > 0) return;\n" + BODY)]),
}
SHAPES = {"decode": (8, 1536), "prefill": (256, 1536), "one_tile": (1, 128)}
BC = 128


def build(_build):
    """{variant: (ctypes entry, registers of the bf16 kernel)}."""
    src = open(os.path.join(_build.CSRC, "relu_bitmap.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (_, edits) in VARIANTS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"relu_bitmap_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"librelu_bitmap_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", so, cu]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}: nvcc failed\n{log}"
        regs, entry = None, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif ("registers" in line and entry
                  and "relu_bitmap_kernelI13__nv_bfloat16" in entry):
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = ctypes.CDLL(so).relu_bitmap
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        out[name] = (fn, regs)
    return out


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    assert torch.cuda.is_available(), "needs a CUDA device"
    from repro_torch.kernels import _build
    from repro_torch.kernels import relu_bitmap as rb
    dev = torch.device("cuda", 0)
    print(cs.gpu_name_and_power(), flush=True)
    fns = build(_build)
    rng = np.random.default_rng(14)
    xs = {}
    for label, (R, C) in SHAPES.items():
        x = rng.standard_normal((R, C), dtype=np.float32)
        x[:, : C // 4] = -np.abs(x[:, : C // 4])  # whole tiles <= 0
        xs[label] = torch.from_numpy(x).to(dev, torch.bfloat16)
    cases = [(v, g, s) for v in VARIANTS for g in ("rule", "one_tile")
             for s in SHAPES]
    for rep, order in enumerate((cases, cases[::-1])):
        for variant, grid, shape in order:
            threads = VARIANTS[variant][0]
            fn, regs = fns[variant]
            x = xs[shape]
            R, C = x.shape
            gc = -(-C // BC)
            tpc = 1 if grid == "one_tile" else max(
                1, min(threads * 8 // BC, gc, rb.RELU_MAX_TILES_PER_CTA))
            y = torch.empty_like(x)
            bits = torch.empty((R, gc), dtype=torch.int32, device=dev)

            def run():
                err = fn(x.data_ptr(), y.data_ptr(), bits.data_ptr(), R, C,
                         1, BC, tpc, 1, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            run()
            torch.cuda.synchronize()
            ok = None
            if not variant.startswith("empty"):
                y0, b0 = rb.relu_bitmap_plain(x, block_r=1, block_c=BC)
                ok = bool(torch.equal(y.view(torch.int16),
                                      y0.view(torch.int16))
                          and torch.equal(bits, b0))
                assert ok, (variant, grid, shape)
            ms, _ = cs.device_time_ms(run, names=cs.RELU_KERNELS)
            print(json.dumps(dict(
                repeat=rep, variant=variant, grid=grid, shape=shape,
                threads=threads, registers=regs, tiles_per_cta=tpc,
                ctas=R * -(-gc // tpc), ok=ok, device_ms=ms,
                graph_ms=cs.graph_time_ms(run))), flush=True)


if __name__ == "__main__":
    main()
