"""Device times of the paged GQA attention, relu_bitmap, relu backward,
fused relu MLP, paged MLA and gated GLU kernels of one source tree,
beside the library calls computing the same functions, on one GPU; for
comparing two trees in turns in one call.

    python tools/kernel_ab.py --src SRC [--label NAME]

SRC is the ``src`` directory of a checkout (this one's by default); its
``repro_torch`` is imported, so its kernels are built from its own
``csrc``. Shapes are ``chip_smoke.py``'s: the GQA kernel at
``time_attention``'s operands (8 slots of the trace's lengths, 3 KV
heads of 3 query rows, head dim 64, 16-row blocks, 32 entries, bf16) and
with every slot at 512 rows; relu_bitmap at the relu decode tick's h (8
x 1536, tile (1, 128)), a 256-row prefill bucket and one (1, 128) tile;
relu_bwd_bitmap at the same decode and prefill operands and at alexnet
conv1's output (3025 x 96, f32, tile (256, 128), through
``ops.relu_bwd_with_bitmap``); the relu MLP at the relu decode tick's
operands (8 rows, block (1, 128), bf16) and at a 256-row prefill bucket
with the same tiles; the MLA
kernel at ``time_mla``'s operands (8 slots of the trace's lengths, 128
heads, R 512, ROPE 64, 16-row blocks); the GLU at ``time_glu``'s decode
operands. Each kernel is called through its module's entry (so neither
tree pads), conv1's relu backward through ``ops``. Times per call: CUDA events around 200 calls, the
profiler's device time of every kernel the call launches
(``chip_smoke.device_time_ms``) and a replayed CUDA graph of 20 calls
(``chip_smoke.graph_time_ms``). Prints one JSON line with the card's
name and power limit. To compare trees, run it once per tree in one
command, in the order parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def witnesses(cs, run, iters=200):
    dev, _ = cs.device_time_ms(run)
    return dict(events=cs.cuda_time_ms(run, iters), device=dev,
                graph=cs.graph_time_ms(run))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    assert torch.cuda.is_available(), "needs a CUDA device"
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_decode_attn as pda
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import relu_bitmap as rb
    from repro_torch.kernels import sparce_glu_mlp as sgm
    from repro_torch.kernels import sparce_mlp as sm
    _build.build(["paged_decode_attn", "relu_bitmap", "sparce_mlp",
                  "paged_mla_decode_attn", "sparce_glu_mlp"])
    dev = torch.device("cuda", 0)
    out = dict(label=args.label, src=os.path.abspath(args.src),
               card=cs.gpu_name_and_power())

    # Paged GQA at time_attention's operands, then every slot at 512 rows.
    B, bs = cs.ENGINE["slots"], cs.ENGINE["block_size"]
    max_blocks = cs.ENGINE["max_len"] // bs
    for name, lengths in (("gqa_decode", cs.trace_lengths()),
                          ("gqa_full_table", [max_blocks * bs] * B)):
        c = cs.attn_case(torch, dev, torch.bfloat16, seed=5, lengths=lengths,
                         max_blocks=max_blocks)
        gargs = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
        out[name] = witnesses(cs, lambda: pda.paged_gqa_decode_attn(*gargs))
        out[name + "_library"] = witnesses(cs, cs.gqa_library(torch, c))

    # relu_bitmap at the decode tick's h, a 256-row prefill, one tile.
    _, _, _, h, _ = cs.relu_decode_operands(torch, dev)
    bc = cs.SPARCE_BLOCKS["block_k"]
    hp = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (256, h.shape[1]), dtype=np.float32)).to(dev, h.dtype)
    for name, x in (("relu_bitmap_decode", h), ("relu_bitmap_prefill", hp),
                    ("relu_bitmap_tile", h[:1, :bc].contiguous())):
        out[name] = witnesses(
            cs, lambda: rb.relu_bitmap(x, block_r=1, block_c=bc))
        out[name + "_library"] = witnesses(cs, cs.relu_library(torch, x, bc))

    # relu_bwd_bitmap at the same decode and prefill operands (the kernel
    # alone), then at phase 7's largest operand, alexnet conv1's output
    # (3025 x 96, f32) at its plan's tile (256, 128), through
    # ops.relu_bwd_with_bitmap (so a tree that pads pays its copies).
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device=dev).manual_seed(15)
    y1 = torch.randn((3025, 96), generator=gen, device=dev)
    cases = (("relu_bwd_decode", h, (1, bc), rb.relu_bwd_bitmap),
             ("relu_bwd_prefill", hp, (1, bc), rb.relu_bwd_bitmap),
             ("relu_bwd_conv1", y1, (256, 128), None))
    for name, x, (br, bcc), fn in cases:
        g = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)

        def run():
            if fn is None:
                return kops.relu_bwd_with_bitmap(x, g, (br, bcc))
            return fn(x, g, block_r=br, block_c=bcc)

        out[name] = witnesses(cs, run)
        out[name + "_library"] = witnesses(
            cs, cs.relu_bwd_library(torch, x, g, br, bcc))

    # The relu MLP: decode, then the 256-row prefill bucket.
    x, wi, wo, _, _ = cs.relu_decode_operands(torch, dev)
    kw = dict(block_m=1, block_f=cs.SPARCE_BLOCKS["block_k"])
    xp = torch.from_numpy(np.abs(np.random.default_rng(13).standard_normal(
        (256, x.shape[1]), dtype=np.float32))).to(dev, x.dtype)
    for name, xx in (("mlp_decode", x), ("mlp_prefill", xp)):
        out[name] = witnesses(cs, lambda: sm.sparce_mlp_fused(xx, wi, wo,
                                                              **kw))
        out[name + "_library"] = witnesses(
            cs, lambda: torch.relu(xx @ wi) @ wo)

    # Paged MLA at time_mla's operands.
    rng = np.random.default_rng(12)
    lengths = rng.integers(cs.ENGINE["prompt_lo"],
                           cs.ENGINE["prompt_hi"] + cs.ENGINE["max_new"], B)
    c = cs.mla_case(torch, dev, torch.bfloat16, seed=12, B=B, bs=bs,
                    max_blocks=max_blocks, lengths=lengths.tolist(),
                    **cs.MLA_DIMS)
    margs = (c["q_lat"], c["q_rope"], c["ckv"], c["kr"], c["tables"],
             c["lengths"])
    out["mla_decode"] = witnesses(
        cs, lambda: pda.paged_mla_decode_attn(*margs, scale=cs.MLA_SCALE))
    cc = kref.gather_pool_view(c["ckv"], c["tables"])
    cr = kref.gather_pool_view(c["kr"], c["tables"])
    qk = torch.cat([c["q_lat"], c["q_rope"]], -1)[:, None].contiguous()
    kk = torch.cat([cc, cr], -1)[:, None].contiguous()
    vv = cc[:, None].contiguous()
    mask = (torch.arange(cc.shape[1], device=dev)[None, :]
            < c["lengths"][:, None])[:, None, None, :]
    out["mla_decode_library"] = witnesses(
        cs, lambda: F.scaled_dot_product_attention(
            qk, kk, vv, attn_mask=mask, scale=cs.MLA_SCALE))

    # The gated GLU at time_glu's decode operands.
    cfg = cs.arch_config()
    g = np.random.default_rng(6)
    K, F_ = cfg.d_model, cfg.d_ff

    def normal(*shape, scale=1.0):
        a = g.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    xg = normal(B, K)
    wg, wgi = normal(K, F_, scale=K ** -0.5), normal(K, F_, scale=K ** -0.5)
    wgo = normal(F_, K, scale=F_ ** -0.5)
    out["glu_decode"] = witnesses(cs, lambda: sgm.sparce_glu_mlp_fused(
        xg, wg, wgi, wgo, block_m=64, block_f=128))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
