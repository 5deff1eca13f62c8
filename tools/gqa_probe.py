"""Device time of the paged GQA decode kernel against its chunk size, on
one GPU.

    python tools/gqa_probe.py [--src SRC]

SRC is the ``src`` directory of a checkout (this one's by default). At
smollm-135m's decode widths (8 slots, 3 KV heads of 3 query rows, head
dim 64, 16-row blocks, 32 table entries, bf16) it calls the wrapper
``paged_gqa_decode_attn`` with the grid's aim ``GQA_CTA_AIM`` set so
that ``gqa_chunks`` cuts each table into chunks of E = 1, 2, 4, 8 and 32
entries (the wrapper's aim gives one of them; the chunks are fixed per
call, so any E gives the same function), on
``chip_smoke.time_attention``'s lengths and with every slot at 512 rows,
and prints per case the device time of the call's kernels from
``torch.profiler`` (``chip_smoke.device_time_ms``) and of a replayed
CUDA graph (``chip_smoke.graph_time_ms``). One JSON line per case, after
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Aims that give E 1, 2, 4, 8 and 32 entries a chunk at 8 slots, one head
# group and 32 table entries (132, the wrapper's, gives 2).
AIMS = (256, 132, 64, 32, 8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import chip_smoke as cs
    assert torch.cuda.is_available(), "needs a CUDA device"
    from repro_torch.kernels import paged_decode_attn as pda
    dev = torch.device("cuda", 0)
    print(cs.gpu_name_and_power(), flush=True)
    B, KV = 8, 3
    bs = cs.ENGINE["block_size"]
    max_blocks = cs.ENGINE["max_len"] // bs
    trace = cs.trace_lengths()
    kept = pda.GQA_CTA_AIM
    for label, lengths in (("trace", trace), ("all 512", [512] * B)):
        c = cs.attn_case(torch, dev, torch.bfloat16, seed=5,
                         lengths=lengths, max_blocks=max_blocks)
        args_ = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
        want = pda.paged_gqa_decode_attn_plain(
            *(t.cpu() for t in args_)).to(dev)
        for aim in AIMS:
            pda.GQA_CTA_AIM = aim
            try:
                s, e = pda.gqa_chunks(B, KV, max_blocks, bs)

                def run():
                    return pda.paged_gqa_decode_attn(*args_)

                err = (run().float() - want.float()).abs().max().item()
                assert err < 2e-2, (label, e, err)
                ms, parts = cs.device_time_ms(run, names=cs.GQA_KERNELS)
                print(json.dumps(dict(
                    lengths=label, entries=e, chunks=s, aim=aim,
                    device_ms=ms, parts=parts,
                    graph_ms=cs.graph_time_ms(run))), flush=True)
            finally:
                pda.GQA_CTA_AIM = kept


if __name__ == "__main__":
    main()
