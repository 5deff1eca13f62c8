"""Device time of the paged MLA decode kernel against its chunk size and
the slots' lengths, on one GPU.

    python tools/mla_probe.py [--src SRC]

SRC is the ``src`` directory of a checkout (this one's by default). At
the DeepSeek decode widths (8 slots, 128 heads, R 512, ROPE 64, 16-row
blocks, 32 table entries, bf16) it calls the kernel's C entry with each
chunk size E of 1, 2, 4, 8, 16 and 32 table entries (the wrapper's rule
picks one of them; the chunks are fixed per call, so any E gives the
same function) on ``chip_smoke.time_mla``'s lengths and on uniform
lengths of 16, 64, 288 and 512 rows, and prints per case the device
time of each of the call's kernels from ``torch.profiler``
(``chip_smoke.device_time_ms``): a per-step slope and a fixed cost per
launch separate there. One JSON line per case, after the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import chip_smoke as cs
    assert torch.cuda.is_available(), "needs a CUDA device"
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    print(cs.gpu_name_and_power(), flush=True)
    B, bs = cs.ENGINE["slots"], cs.ENGINE["block_size"]
    max_blocks = cs.ENGINE["max_len"] // bs
    h, r, rope = cs.MLA_DIMS["h"], cs.MLA_DIMS["r"], cs.MLA_DIMS["rope"]
    rng = np.random.default_rng(12)
    trace = rng.integers(cs.ENGINE["prompt_lo"],
                         cs.ENGINE["prompt_hi"] + cs.ENGINE["max_new"], B)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("paged_mla_decode_attn", "paged_mla_decode_attn",
                         [p] * 8 + [i] * 8 + [ctypes.c_float, i, p])
    cases = [("trace", trace.tolist())] + [
        (f"all {n}", [n] * B) for n in (16, 64, 288, 512)]
    for label, lengths in cases:
        c = cs.mla_case(torch, dev, torch.bfloat16, seed=12, B=B, bs=bs,
                        max_blocks=max_blocks, lengths=lengths, **cs.MLA_DIMS)
        out = torch.empty_like(c["q_lat"])
        for e in (1, 2, 4, 8, 16, 32):
            s = -(-max_blocks // e)
            scratch = torch.empty((B, s, h, -(-(r + 2) // 4) * 4),
                                  dtype=torch.float32, device=dev)

            def run():
                err = fn(c["q_lat"].data_ptr(), c["q_rope"].data_ptr(),
                         c["ckv"].data_ptr(), c["kr"].data_ptr(),
                         c["tables"].data_ptr(), c["lengths"].data_ptr(),
                         out.data_ptr(), scratch.data_ptr(), B, h, r, rope,
                         bs, max_blocks, e, s, cs.MLA_SCALE, 1,
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            ms, parts = cs.device_time_ms(run, names=cs.MLA_KERNELS)
            print(json.dumps(dict(lengths=label, entries=e, chunks=s,
                                  device_ms=ms, parts=parts)), flush=True)


if __name__ == "__main__":
    main()
