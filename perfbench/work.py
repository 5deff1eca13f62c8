"""The work a step or a kernel call needs, counted from shapes alone.

FLOPs count 2 per multiply-add of every product the work needs; bytes
count each input byte once and each output byte once, whatever a kernel
reads again. Where the inputs leave part of the work dead (the SparCE
bits, the lengths of a paged cache), only the live part counts. The
peaks are one H100 SXM's (NVIDIA's data sheet, dense, 700 W).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

PEAK_FLOPS = 989.4e12  # dense bf16 FLOP/s of one H100 SXM
HBM_BW = 3.35e12  # HBM3 bytes/s of one H100 SXM


def shapes(cfg: Dict) -> Dict[str, int]:
    """The sizes the counts need, from a configuration's published keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(L=cfg["num_hidden_layers"], d=d, h=h,
                kv=cfg["num_key_value_heads"],
                hd=cfg.get("head_dim") or d // h,
                ff=cfg["intermediate_size"], V=cfg["vocab_size"],
                tied=bool(cfg.get("tie_word_embeddings", False)))


def n_params(cfg: Dict) -> int:
    """Every weight: embedding, head (unless tied), layers, norms."""
    s = shapes(cfg)
    d, hd = s["d"], s["hd"]
    layer = (d * s["h"] * hd + 2 * d * s["kv"] * hd + s["h"] * hd * d
             + 3 * d * s["ff"] + 2 * d)
    return (s["L"] * layer + d + s["V"] * d * (1 if s["tied"] else 2))


def layer_matmul_flops(cfg: Dict) -> int:
    """FLOPs of one token through one layer's weight products."""
    s = shapes(cfg)
    d, hd = s["d"], s["hd"]
    return 2 * (d * s["h"] * hd + 2 * d * s["kv"] * hd + s["h"] * hd * d
                + 3 * d * s["ff"])


def attn_flops(cfg: Dict, keys: int) -> int:
    """FLOPs of one query token's attention products over ``keys`` keys,
    over all layers (scores and the weighted sum)."""
    s = shapes(cfg)
    return 4 * s["h"] * s["hd"] * keys * s["L"]


def head_flops(cfg: Dict) -> int:
    s = shapes(cfg)
    return 2 * s["d"] * s["V"]


def prefill_flops(cfg: Dict, prompt: int) -> int:
    """A prompt of ``prompt`` real tokens (no bucket padding): every
    token through the layers, each attending over its causal context,
    and the head at the last token only."""
    s = shapes(cfg)
    return (prompt * s["L"] * layer_matmul_flops(cfg)
            + attn_flops(cfg, prompt * (prompt + 1) // 2) + head_flops(cfg))


def decode_flops(cfg: Dict, keys: int) -> int:
    """One decoded token whose input attends over ``keys`` cached rows
    (itself included), with its logits."""
    s = shapes(cfg)
    return (s["L"] * layer_matmul_flops(cfg) + attn_flops(cfg, keys)
            + head_flops(cfg))


def train_flops(cfg: Dict, batch: int, seq: int) -> int:
    """One training step over ``batch`` sequences of ``seq`` tokens:
    three times the forward (whose head runs at the seq - 1 predicted
    positions), recomputation not counted."""
    s = shapes(cfg)
    fwd = (seq * s["L"] * layer_matmul_flops(cfg)
           + attn_flops(cfg, seq * (seq + 1) // 2)
           + (seq - 1) * head_flops(cfg))
    return 3 * batch * fwd


# -------------------------------------------------------------- kernels
def _edges(n: int, block: int) -> np.ndarray:
    """Sizes of the tiles that cut ``n`` into ``block`` (the last ragged)."""
    return np.minimum(block, n - np.arange(0, n, block)).astype(np.float64)


def paged_gqa(batch: int, kv: int, group: int, head_dim: int,
              block_size: int, lengths, elt: int) -> Dict[str, float]:
    """Paged GQA decode: each slot's queries over its ``lengths[b]`` live
    rows (0 = an empty slot reads nothing); bytes of those K and V rows,
    q, the output, the lengths and the live table entries."""
    ls = np.maximum(np.asarray(lengths, np.int64), 0)
    rows = float(ls.sum())
    flops = 4.0 * group * kv * head_dim * rows
    entries = float((-(-ls // block_size)).sum())
    nbytes = (elt * (2 * rows * kv * head_dim + 2 * batch * kv * group
                     * head_dim) + 4 * (batch + entries))
    return {"flops": flops, "bytes": float(nbytes)}


def gated_gemm(m: int, k: int, n: int, block_m: int, block_k: int,
               block_n: int, gate: str, bits, elt_x: int, elt_w: int,
               elt_y: int) -> Dict[str, float]:
    """``y = x @ w`` with the tile products of dead tiles dropped:
    ``gate='lhs'`` bits over x's (row, k) tiles, ``'rhs'`` over w's (k,
    n) tiles (1 = dead). Bytes of the live x and w tiles (a stripe read
    by any live product once), y and the bits."""
    ks = _edges(k, block_k)
    if gate == "lhs":
        rows = _edges(m, block_m)
        live = np.asarray(bits)[:len(rows), :len(ks)] == 0
        area = float(rows @ live.astype(np.float64) @ ks)  # live x elements
        flops = 2.0 * area * n
        xb, wb = area, float(ks[live.any(axis=0)].sum()) * n
    elif gate == "rhs":
        cols = _edges(n, block_n)
        live = np.asarray(bits)[:len(ks), :len(cols)] == 0
        area = float(ks @ live.astype(np.float64) @ cols)  # live w elements
        flops = 2.0 * m * area
        xb, wb = m * float(ks[live.any(axis=1)].sum()), area
    else:
        raise ValueError(f"unknown gate {gate!r}")
    nbytes = elt_x * xb + elt_w * wb + elt_y * m * n + 4 * live.size
    return {"flops": flops, "bytes": float(nbytes)}
