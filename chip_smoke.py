#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure exits non-zero, and the closing ``{"ok": true}`` line
is printed only when all of them pass):

  1. the card's name and power limit (``nvidia-smi``), then the build of
     every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, all at once) and its time;
  2. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes, in bf16 and f32, with NaN-poisoned dead
     pool blocks, dead weight stripes and gated tiles, bits exactly;
  3. one f32 full-width ``serving_decode_step`` of smollm-135m with the
     kernels (CUDA) against the same step with the plain versions (CPU):
     the gated-GLU MLP, and the relu MLP (``--sparce``) in
     ``mode="fused"`` and ``mode="kernel"``;
  4. the full-width bf16 gated-GLU engine, ``Server.generate`` on a
     seeded mixed trace, with the launch counts of its kernels read
     around the run;
  5. the full-width bf16 relu engine (the launcher's ``--sparce``:
     per-slot tiles, block_m 1, block_k 128) on the same trace, once in
     ``mode="fused"`` and once in ``mode="kernel"``, each with its
     kernels' launch counts; then every kernel's time at the decode
     shapes beside its plain version, a library yardstick and its bound.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data-sheet peaks (dense): HBM bandwidth, and the rate of each
# dtype's best matrix path (bf16 tensor cores; f32 outside them, since
# the port runs f32 products at full precision, TF32 off).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

ARCH = "smollm-135m"
ENGINE = dict(requests=16, prompt_lo=16, prompt_hi=256, max_new=32,
              slots=8, max_len=512, block_size=16, seed=0)
# The launcher's --sparce tiling: per-slot rows, 128-wide f stripes.
SPARCE_BLOCKS = dict(block_m=1, block_k=128)


def arch_config():
    from repro_torch.configs import get_config
    return get_config(ARCH)


def relu_config():
    """The arch with the launcher's --sparce swap: a relu MLP (w_in,
    w_out; no w_gate)."""
    import dataclasses
    return dataclasses.replace(arch_config(), mlp_act="relu")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
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


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, *, atol, rtol, why):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    log(f"  {name}: max_abs_err={err:.3e} (atol={atol}, rtol={rtol}: {why})"
        f" -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree")
    return err


# ------------------------------------------------------------ attention
def attn_case(torch, dev, dtype, seed, *, B=8, KV=3, g=3, D=64, bs=16,
              max_blocks=32, lengths=None):
    """Pools, tables and ragged lengths; dead table entries (past each
    live prefix) point at blocks no live prefix uses."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = [0, 1, 15, 16, 17, 100, 255, 512]
    live = [-(-n // bs) for n in lengths]
    nb = sum(live) + 1 + 16  # null block, live blocks, 16 spare blocks
    ids = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, max_blocks), np.int32)
    nxt = 0
    for b in range(B):
        tables[b, : live[b]] = ids[nxt: nxt + live[b]]
        nxt += live[b]
    spare = ids[nxt:]
    for b in range(B):  # dead entries name unused (later poisoned) blocks
        tables[b, live[b]:] = rng.choice(spare, max_blocks - live[b])
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return dict(q=mk(B, KV, g, D), k=mk(nb, bs, KV, D), v=mk(nb, bs, KV, D),
                tables=torch.from_numpy(tables).to(dev),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
                live_ids=set(ids[:nxt].tolist()), nb=nb)


def check_attention(torch, dev):
    from repro_torch.kernels import paged_decode_attn as pda
    from repro_torch.kernels import ref as kref
    tols = {
        torch.float32: (1e-5, 1e-5, "f32 sums in another order"),
        torch.bfloat16: (2e-2, 2e-2, "bf16 p rounded against a running "
                         "max in the kernel, against the final max in the "
                         "plain version; bf16 output rounding"),
    }
    errs = {}
    for dtype, (atol, rtol, why) in tols.items():
        c = attn_case(torch, dev, dtype, seed=1)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
        got = pda.paged_gqa_decode_attn(*args)
        want = pda.paged_gqa_decode_attn_plain(*args)
        torch.cuda.synchronize()
        name = f"paged_gqa_decode_attn {str(dtype)[6:]}"
        errs[dtype] = check_close(name, got, want, atol=atol, rtol=rtol,
                                  why=why)
        live = c["lengths"] > 0
        oracle = kref.paged_gqa_decode_attn_ref(*args)
        check_close(name + " vs gather oracle (live slots)", got[live],
                    oracle[live], atol=atol, rtol=rtol, why=why)
        if not bool((got[~live] == 0).all()):
            raise AssertionError("a length-0 slot did not produce zeros")
        # NaN poison: every block outside the live prefixes (incl. the
        # blocks dead table entries name) -> output bit-identical.
        dead = [i for i in range(c["nb"]) if i not in c["live_ids"]]
        kp, vp = c["k"].clone(), c["v"].clone()
        kp[dead] = float("nan")
        vp[dead] = float("nan")
        poisoned = pda.paged_gqa_decode_attn(c["q"], kp, vp, c["tables"],
                                             c["lengths"])
        torch.cuda.synchronize()
        if not (torch.isfinite(poisoned).all() and torch.equal(poisoned, got)):
            raise AssertionError("NaN-poisoned dead blocks reached the output")
        log(f"  {name}: NaN-poisoned dead blocks never read -> ok")
    return errs[torch.bfloat16]


# ------------------------------------------------------------------ GLU
def glu_case(torch, dev, dtype, seed, *, M=8, K=576, F=1536, N=576,
             bf=128):
    """x with all-zero rows; some gate stripes exactly zero (dead at any
    tau) and some tiny (dead at tau=0.05 only)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    x[M // 2:] = 0.0
    wg = rng.standard_normal((K, F), dtype=np.float32) / np.sqrt(K)
    nf = F // bf
    wg[:, 2 * bf: 3 * bf] = 0.0
    wg[:, 5 * bf: 6 * bf] = 0.0
    wg[:, 7 * bf: 8 * bf] *= 1e-3
    wg[:, (nf - 1) * bf:] *= 1e-3
    wi = rng.standard_normal((K, F), dtype=np.float32) / np.sqrt(K)
    wo = rng.standard_normal((F, N), dtype=np.float32) / np.sqrt(F)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    return t(x), t(wg), t(wi), t(wo)


def check_glu(torch, dev):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_glu_mlp as sgm
    bm, bf = 64, 128
    tols = {
        torch.float32: (1e-4, 1e-4, "f32 sums over K and F in another "
                        "order"),
        torch.bfloat16: (2e-2, 2e-2, "g rounded to bf16 after sums in "
                         "another order can move one ulp; bf16 output "
                         "rounding"),
    }
    err_main = None
    for dtype, (atol, rtol, why) in tols.items():
        for M in (8, 100):  # decode slots; a prefill bucket (2 row tiles)
            for tau in (0.0, 0.05):
                x, wg, wi, wo = glu_case(torch, dev, dtype, seed=2, M=M)
                pm = -(-M // bm) * bm
                xp = torch.nn.functional.pad(x, (0, 0, 0, pm - M))
                y, bits = sgm.sparce_glu_mlp_fused(
                    xp, wg, wi, wo, block_m=bm, block_f=bf, tau=tau)
                y0, bits0 = sgm.sparce_glu_mlp_fused_plain(
                    xp, wg, wi, wo, block_m=bm, block_f=bf, tau=tau)
                torch.cuda.synchronize()
                name = (f"sparce_glu_mlp_fused {str(dtype)[6:]} M={M} "
                        f"tau={tau}")
                if not torch.equal(bits, bits0):
                    raise AssertionError(f"{name}: bits differ")
                dead = int(bits.sum())
                if dead == 0:
                    raise AssertionError(f"{name}: expected dead stripes")
                err = check_close(f"{name} ({dead} dead tiles)", y, y0,
                                  atol=atol, rtol=rtol, why=why)
                if dtype == torch.bfloat16 and M == 8 and tau == 0.0:
                    err_main = err
                # NaN poison the dead stripes' w_in columns and w_out rows
                # of every row tile that has them dead in ALL row tiles.
                dead_f = bits.bool().all(dim=0).nonzero().flatten().tolist()
                wi2, wo2 = wi.clone(), wo.clone()
                for f in dead_f:
                    wi2[:, f * bf:(f + 1) * bf] = float("nan")
                    wo2[f * bf:(f + 1) * bf] = float("nan")
                y2, bits2 = sgm.sparce_glu_mlp_fused(
                    xp, wg, wi2, wo2, block_m=bm, block_f=bf, tau=tau)
                torch.cuda.synchronize()
                if not (torch.isfinite(y2).all() and torch.equal(y2, y)
                        and torch.equal(bits2, bits)):
                    raise AssertionError(
                        f"{name}: NaN-poisoned dead stripes reached y")
        # The padded wrapper the model calls: ragged M, dead pad rows.
        x, wg, wi, wo = glu_case(torch, dev, dtype, seed=3, M=8)
        y, bmp = kops.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=bm,
                                           block_f=bf)
        y0, bmp0 = kops.sparce_glu_mlp_fused(x.cpu(), wg.cpu(), wi.cpu(),
                                             wo.cpu(), block_m=bm,
                                             block_f=bf)
        if not torch.equal(bmp.bits.cpu(), bmp0.bits):
            raise AssertionError("padded wrapper: bits differ from the CPU")
        log(f"  ops.sparce_glu_mlp_fused {str(dtype)[6:]} (M=8 padded to "
            f"{bm}): bits equal to the CPU plain version's -> ok")
        # Per-slot gate tiles (block_m 1), the launcher's --sparce tiling
        # for a GLU arch: the zero rows are dead in every stripe.
        x, wg, wi, wo = glu_case(torch, dev, dtype, seed=4, M=8)
        y, bits = sgm.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=1,
                                           block_f=bf)
        y0, bits0 = sgm.sparce_glu_mlp_fused_plain(x, wg, wi, wo, block_m=1,
                                                   block_f=bf)
        torch.cuda.synchronize()
        name = f"sparce_glu_mlp_fused {str(dtype)[6:]} M=8 block_m=1"
        if not (torch.equal(bits, bits0) and bool(bits[4:].all())):
            raise AssertionError(f"{name}: bits differ or rows not dead")
        check_close(f"{name} ({int(bits.sum())} dead tiles)", y, y0,
                    atol=atol, rtol=rtol, why=why)
    log("  sparce_glu_mlp_fused: NaN-poisoned dead w_in/w_out stripes "
        "never read (every case above) -> ok")
    return err_main


# --------------------------------------------------- relu-family kernels
# (M, block_m) of the checks: a decode tick of 8 slots and a 256-row
# prefill bucket at the launcher's per-slot tiles, and 64-row tiles.
RELU_CASES = ((8, 1), (256, 1), (256, 64))
RELU_TOLS = {
    "float32": (1e-4, 1e-4, "f32 sums over K (and F) in another order"),
    "bfloat16": (2e-2, 2e-2, "bf16 output rounding after f32 sums in "
                 "another order"),
}


def mlp_case(torch, dev, dtype, seed, *, M, bm, K=576, F=1536, N=576,
             bf=128):
    """Nonnegative x with one dead row tile; w_in's stripe 2 negative so
    it is dead in every row tile; init-scale weights."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((M, K), dtype=np.float32))
    x[M // 2: M // 2 + bm] = 0.0
    wi = rng.standard_normal((K, F), dtype=np.float32) / np.sqrt(K)
    wi[:, 2 * bf: 3 * bf] = -np.abs(wi[:, 2 * bf: 3 * bf])
    wo = rng.standard_normal((F, N), dtype=np.float32) / np.sqrt(F)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    return t(x), t(wi), t(wo)


def check_relu_bitmap(torch, dev):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import relu_bitmap as rb
    for dtype in (torch.float32, torch.bfloat16):
        for M, bm in RELU_CASES:
            rng = np.random.default_rng(M + bm)
            h = rng.standard_normal((M, 1536), dtype=np.float32)
            h[: bm, :128] = -1.0  # no element > 0
            h[M // 2: M // 2 + bm] = 0.0
            ht = torch.from_numpy(h).to(dev, dtype)
            y, bits = rb.relu_bitmap(ht, block_r=bm, block_c=128)
            y0, bits0 = rb.relu_bitmap_plain(ht, block_r=bm, block_c=128)
            torch.cuda.synchronize()
            name = f"relu_bitmap {str(dtype)[6:]} M={M} block=({bm},128)"
            if not (torch.equal(y, y0) and torch.equal(bits, bits0)):
                raise AssertionError(f"{name}: y or bits differ")
            if not (bool(bits[0, 0]) and bool(bits[M // 2 // bm].all())):
                raise AssertionError(f"{name}: dead tiles not flagged")
            log(f"  {name}: y and bits equal the plain version's "
                f"({int(bits.sum())} dead tiles) -> ok")
        # The padded wrapper: 8 rows over 64-row tiles.
        ht = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (8, 1536), dtype=np.float32)).to(dev, dtype)
        y, bmp = kops.relu_with_bitmap(ht, (64, 128))
        y0, bmp0 = kops.relu_with_bitmap(ht.cpu(), (64, 128))
        if not (torch.equal(y.cpu(), y0) and torch.equal(bmp.bits.cpu(),
                                                         bmp0.bits)):
            raise AssertionError("ops.relu_with_bitmap differs from the CPU")
    return 0.0  # relu is exact: y equals the plain version bit for bit


def check_gemm(torch, dev):
    from repro_torch.kernels import sparce_gemm as sg
    K, N, bk, bn = 1536, 576, 128, 128
    err_main = None
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol, why = RELU_TOLS[str(dtype)[6:]]
        # (8, 64): M ragged over the row tile, masked in the kernel.
        for M, bm in RELU_CASES + ((8, 64),):
            for gate in ("lhs", "rhs"):
                rng = np.random.default_rng(M + bm + (gate == "rhs"))
                x = rng.standard_normal((M, K), dtype=np.float32)
                w = rng.standard_normal((K, N), dtype=np.float32) / np.sqrt(K)
                grid = sg.bit_grid(M, K, N, block_m=bm, block_k=bk,
                                   block_n=bn, gate=gate)
                bits = (rng.random(grid) < 0.3).astype(np.int32)
                bits[:, 3] = 1  # gated in every row tile / column tile
                xt = torch.from_numpy(x).to(dev, dtype)
                wt = torch.from_numpy(w).to(dev, dtype)
                bt = torch.from_numpy(bits).to(dev)
                kw = dict(block_m=bm, block_k=bk, block_n=bn, gate=gate)
                y = sg.sparce_gemm_gated(xt, wt, bt, **kw)
                y0 = sg.sparce_gemm_gated_plain(xt, wt, bt, **kw)
                torch.cuda.synchronize()
                name = (f"sparce_gemm_gated {str(dtype)[6:]} gate={gate} "
                        f"M={M} block_m={bm} (N={N} ragged over {bn})")
                err = check_close(name, y, y0, atol=atol, rtol=rtol, why=why)
                if (dtype == torch.bfloat16 and (M, bm) == (8, 1)
                        and gate == "lhs"):
                    err_main = err
                # NaN poison: gated operand tiles, and (lhs) w's k-stripe
                # gated in every row tile.
                x2, w2 = xt.clone(), wt.clone()
                for i, j in zip(*np.nonzero(bits)):
                    if gate == "lhs":
                        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = np.nan
                    else:
                        w2[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = np.nan
                if gate == "lhs":
                    w2[3 * bk: 4 * bk] = float("nan")
                y2 = sg.sparce_gemm_gated(x2, w2, bt, **kw)
                torch.cuda.synchronize()
                if not (torch.isfinite(y2).all() and torch.equal(y2, y)):
                    raise AssertionError(
                        f"{name}: NaN-poisoned gated tiles reached y")
    log("  sparce_gemm_gated: NaN-poisoned gated tiles never read (every "
        "case above) -> ok")
    return err_main


def check_mlp(torch, dev):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_mlp as sm
    bf = 128
    err_main = None
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol, why = RELU_TOLS[str(dtype)[6:]]
        for M, bm in RELU_CASES:
            for act in ("relu", "relu2"):
                x, wi, wo = mlp_case(torch, dev, dtype, seed=M + bm, M=M,
                                     bm=bm)
                kw = dict(block_m=bm, block_f=bf, act=act)
                y, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
                y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **kw)
                torch.cuda.synchronize()
                name = (f"sparce_mlp_fused {str(dtype)[6:]} {act} M={M} "
                        f"block_m={bm}")
                if not torch.equal(bits, bits0):
                    raise AssertionError(f"{name}: bits differ")
                if not (bool(bits[:, 2].all())
                        and bool(bits[M // 2 // bm].all())):
                    raise AssertionError(f"{name}: dead tiles not flagged")
                err = check_close(f"{name} ({int(bits.sum())} dead tiles)",
                                  y, y0, atol=atol, rtol=rtol, why=why)
                if dtype == torch.bfloat16 and M == 8 and act == "relu":
                    err_main = err
                # NaN poison the w_out rows of the stripes dead in every
                # row tile.
                dead_f = bits.bool().all(dim=0).nonzero().flatten().tolist()
                wo2 = wo.clone()
                for f in dead_f:
                    wo2[f * bf:(f + 1) * bf] = float("nan")
                y2, bits2 = sm.sparce_mlp_fused(x, wi, wo2, **kw)
                torch.cuda.synchronize()
                if not (torch.isfinite(y2).all() and torch.equal(y2, y)
                        and torch.equal(bits2, bits)):
                    raise AssertionError(
                        f"{name}: NaN-poisoned dead stripes reached y")
        # The padded wrapper the model calls: 8 rows over 64-row tiles.
        x, wi, wo = mlp_case(torch, dev, dtype, seed=5, M=8, bm=1)
        y, bmp = kops.sparce_mlp_fused(x, wi, wo, block_m=64, block_f=bf)
        y0, bmp0 = kops.sparce_mlp_fused(x.cpu(), wi.cpu(), wo.cpu(),
                                         block_m=64, block_f=bf)
        if not torch.equal(bmp.bits.cpu(), bmp0.bits):
            raise AssertionError("padded wrapper: bits differ from the CPU")
        log(f"  ops.sparce_mlp_fused {str(dtype)[6:]} (M=8 padded to 64): "
            "bits equal to the CPU plain version's -> ok")
    log("  sparce_mlp_fused: NaN-poisoned dead w_out stripes never read "
        "(every case above) -> ok")
    return err_main


# ------------------------------------------------------- decode-step parity
def decode_state(torch, cfg, dev, seed, *, B=8, max_blocks=8, bs=16):
    """Random pools, ragged live lengths, dead slots, block tables."""
    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(seed)
    lengths = [0, 3, 16, 31, 64, 100, 0, 127]
    nb = B * max_blocks + 1
    caches = model_lib.init_paged_caches(cfg, B, nb, bs, device=dev)
    c = caches["stack"]
    c.k.copy_(torch.from_numpy(rng.standard_normal(
        tuple(c.k.shape), dtype=np.float32)))
    c.v.copy_(torch.from_numpy(rng.standard_normal(
        tuple(c.v.shape), dtype=np.float32)))
    c.length.copy_(torch.tensor(lengths, dtype=torch.int32)[None, :].expand(
        cfg.num_layers, B))
    tables = np.zeros((B, max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    nxt = 0
    for b, n in enumerate(lengths):
        k = -(-(n + 1) // bs) if n else 0  # room for this tick's write
        tables[b, :k] = ids[nxt:nxt + k]
        nxt += k
    active = np.array([n > 0 for n in lengths], np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 1))
    return caches, tables, active, toks


def to_device(tree, dev):
    import torch
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(v, dev) for v in tree))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def check_decode_step(torch, dev, base_cfg, sparsity, label):
    """One f32 full-width decode step of ``base_cfg`` under ``sparsity``:
    kernels on the card against plain versions on the CPU."""
    import dataclasses
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(base_cfg, dtype="float32", sparsity=sparsity)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    caches, tables, active, toks = decode_state(torch, cfg, dev, seed=4)
    cpu = torch.device("cpu")
    params_cpu = to_device(params, cpu)
    caches_cpu = to_device(caches, cpu)
    outs = []
    for where, p, c in ((dev, params, caches), (cpu, params_cpu,
                                                 caches_cpu)):
        with torch.no_grad():
            logits, _, skip = model_lib.serving_decode_step(
                p, cfg, torch.from_numpy(toks).to(where), c,
                torch.from_numpy(active).to(where),
                torch.from_numpy(tables).to(where), attn_kernel="paged")
        outs.append((logits[:, -1].float().cpu(), skip.cpu()))
    (lg, sk), (lc, skc) = outs
    live = torch.from_numpy(active).bool()
    atol = rtol = 1e-3
    check_close(f"{label}: f32 serving_decode_step logits (live slots), "
                "kernels on the GPU vs plain versions on the CPU", lg[live],
                lc[live], atol=atol, rtol=rtol,
                why="30 layers of f32 sums in another order")
    if not torch.equal(sk, skc):
        raise AssertionError(f"{label}: skip stats differ: {sk} vs {skc}")
    top2 = lc[live].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * atol
    same = lg[live].argmax(-1) == lc[live].argmax(-1)
    if not bool(same[clear].all()):
        raise AssertionError("argmax differs where the top-2 gap is clear")
    log(f"  {label}: argmax equal on {int(clear.sum())}/{int(live.sum())} "
        f"live slots with a clear top-2 gap; skip stats {sk.tolist()} "
        "equal -> ok")


# ------------------------------------------------------------ the engine
def engine_requests(cfg, n, seed, *, mixed=False):
    """The seeded trace: prompts of ENGINE's lengths, ENGINE["max_new"]
    tokens each; with ``mixed`` each budget is drawn from
    [max_new // 4, max_new] (the launcher's --mixed rule), so slots free
    at different ticks and the tail runs with dead slots."""
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(seed)
    budgets = [ENGINE["max_new"]] * n
    if mixed:
        budgets = np.random.default_rng(seed + 1).integers(
            ENGINE["max_new"] // 4, ENGINE["max_new"] + 1, n).tolist()
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(ENGINE["prompt_lo"],
                                            ENGINE["prompt_hi"] + 1))),
        max_new=int(budgets[i])) for i in range(n)]


def counters():
    """{kernel name: its wrapper}; each wrapper counts its launches."""
    from repro_torch.kernels import paged_decode_attn as pda
    from repro_torch.kernels import relu_bitmap as rb
    from repro_torch.kernels import sparce_gemm as sg
    from repro_torch.kernels import sparce_glu_mlp as sgm
    from repro_torch.kernels import sparce_mlp as sm
    return {"paged_gqa_decode_attn": pda.paged_gqa_decode_attn,
            "sparce_glu_mlp_fused": sgm.sparce_glu_mlp_fused,
            "sparce_mlp_fused": sm.sparce_mlp_fused,
            "relu_bitmap": rb.relu_bitmap,
            "sparce_gemm_gated": sg.sparce_gemm_gated}


def run_engine(torch, dev, cfg, params, sparsity, label, expect, *,
               mixed=False):
    """Serve the seeded trace once on the full-width bf16 engine; every
    kernel in ``expect`` must have launched during the run. Returns
    (metrics, {kernel: launches in the run})."""
    from repro_torch.runtime.server import ServeConfig, Server
    sc = ServeConfig(
        batch_slots=ENGINE["slots"], max_len=ENGINE["max_len"],
        kv_block_size=ENGINE["block_size"], attn_kernel="paged",
        sparsity=sparsity)
    # Warm-up run (library loads, allocator, cuBLAS handles).
    Server(cfg, params, sc, device=dev).generate(
        engine_requests(cfg, 2, seed=99))
    srv = Server(cfg, params, sc, device=dev)
    reqs = engine_requests(cfg, ENGINE["requests"], seed=ENGINE["seed"],
                           mixed=mixed)
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = srv.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    m = srv.metrics
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)}/{len(reqs)} requests completed")
    for r in done:
        if len(r.out) != r.max_new:  # no EOS: every budget runs out
            raise AssertionError(f"uid={r.uid}: {len(r.out)} tokens")
        if not np.all((r.out >= 0) & (r.out < cfg.vocab_size)):
            raise AssertionError(f"uid={r.uid}: token out of range")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not m.attn_block_skip_fraction > 0:
        raise AssertionError("no attention block was skipped")
    if not 0 <= m.skipped_tile_dots <= m.total_tile_dots:
        raise AssertionError("inconsistent skip counters")
    if srv._st.alloc.in_use or srv._st.alloc.reserved:
        raise AssertionError("KV pool did not drain")
    decode_tps = m.decode_tokens / m.decode_s
    log(f"  {label}: served {len(done)} requests: {int(m.decode_tokens)} "
        f"decode tokens in {int(m.ticks)} ticks; wall {wall:.3f}s; prefill "
        f"{int(m.prefill_tokens)} tokens in {m.prefill_s:.3f}s")
    log(f"  {label}: decode {decode_tps:.1f} tokens/s, "
        f"{1e3 * m.decode_s / m.ticks:.3f} ms per decode tick")
    log(f"  {label}: mlp_skip_fraction={m.mlp_skip_fraction:.4f} "
        f"({m.skipped_tile_dots:.0f}/{m.total_tile_dots:.0f}; prefill "
        f"{m.prefill_skipped_tile_dots:.0f}/{m.prefill_total_tile_dots:.0f})"
        f"; attn_block_skip_fraction={m.attn_block_skip_fraction:.4f} "
        f"({int(m.attn_blocks_fetched)}/{int(m.attn_blocks_total)} blocks)")
    log(f"  {label}: launches on the main path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    profile_engine(torch, cfg, params, sc, dev, label)
    return m, launches


def full_width_params(torch, cfg, dev):
    from repro_torch.models import model as model_lib
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=ENGINE["seed"], device=dev)
    torch.cuda.synchronize()
    log(f"  full-width bf16 {cfg.mlp_act} params "
        f"({sum(p.numel() for p in _leaves(params))} values) in "
        f"{time.perf_counter() - t0:.2f}s")
    return params


def run_glu_engine(torch, dev):
    from repro_torch.core.sparse_ops import SparsityConfig
    cfg = arch_config()
    params = full_width_params(torch, cfg, dev)
    _, launches = run_engine(
        torch, dev, cfg, params,
        SparsityConfig(enabled=True, mode="fused", gate_threshold=0.0,
                       autotune=False),
        "glu fused", ("paged_gqa_decode_attn", "sparce_glu_mlp_fused"))
    return launches


SKIP_COUNTERS = ("skipped_tile_dots", "total_tile_dots",
                 "prefill_skipped_tile_dots", "prefill_total_tile_dots",
                 "ticks", "decode_tokens", "prefill_tokens")


def run_relu_engines(torch, dev):
    """The launcher's --sparce engine in both kernel modes on the mixed
    budgets (with the fixed ones every slot is live on every tick, so no
    MLP tile is ever dead); returns {mode: launches}. The integer skip
    counters must be equal: there is no EOS, so the slot schedule does
    not depend on the tokens."""
    from repro_torch.core.sparse_ops import SparsityConfig
    cfg = relu_config()
    params = full_width_params(torch, cfg, dev)
    expect = {"fused": ("paged_gqa_decode_attn", "sparce_mlp_fused"),
              "kernel": ("paged_gqa_decode_attn", "relu_bitmap",
                         "sparce_gemm_gated")}
    metrics, launches = {}, {}
    for mode in ("fused", "kernel"):
        sp = SparsityConfig(enabled=True, mode=mode, autotune=False,
                            **SPARCE_BLOCKS)
        metrics[mode], launches[mode] = run_engine(
            torch, dev, cfg, params, sp, f"relu {mode}", expect[mode],
            mixed=True)
        if not metrics[mode].mlp_skip_fraction > 0:
            raise AssertionError(f"relu {mode}: no MLP tile skipped")
    for name in SKIP_COUNTERS:
        a, b = (getattr(metrics[m], name) for m in ("fused", "kernel"))
        if a != b:
            raise AssertionError(f"{name}: fused {a} != kernel {b}")
    log(f"  relu fused vs kernel: {', '.join(SKIP_COUNTERS)} equal -> ok")
    return launches


def profile_engine(torch, cfg, params, sc, dev, label):
    """Device time by kernel over a short engine run under the profiler
    (its own overhead lengthens the wall time, so the busy share printed
    is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.server import Server
    srv = Server(cfg, params, sc, device=dev)
    reqs = engine_requests(cfg, ENGINE["slots"], seed=7)
    for r in reqs:
        r.max_new = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side events only (kernels, memcpy/memset); the CPU-side
    # aten ops that launched them would count the same time again.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    total_us = sum(dev_us(e) for e in events)
    if not events:
        log("  profiler: no device time recorded")
        return
    log(f"  {label} profiler ({int(srv.metrics.ticks)} ticks, "
        f"{int(srv.metrics.admitted)} prefills): device busy "
        f"{total_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({total_us / 1e4 / wall:.1f}%)")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:70]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- timing
def time_attention(torch, dev, err):
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attn as pda
    from repro_torch.kernels import ref as kref
    rng = np.random.default_rng(5)
    B, KV, g, D, bs = 8, 3, 3, 64, 16
    max_blocks = ENGINE["max_len"] // bs
    lengths = rng.integers(ENGINE["prompt_lo"],
                           ENGINE["prompt_hi"] + ENGINE["max_new"], B)
    c = attn_case(torch, dev, torch.bfloat16, seed=5, lengths=lengths.tolist(),
                  max_blocks=max_blocks)
    args = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
    ms = cuda_time_ms(lambda: pda.paged_gqa_decode_attn(*args), 200)
    plain_ms = cuda_time_ms(lambda: pda.paged_gqa_decode_attn_plain(*args),
                            10, warmup=1)
    # Yardstick: SDPA over the gathered full view (gather done outside).
    kv = kref.gather_pool_view(c["k"], c["tables"]).transpose(1, 2)
    vv = kref.gather_pool_view(c["v"], c["tables"]).transpose(1, 2)
    kv, vv = kv.contiguous(), vv.contiguous()
    qh = c["q"].reshape(B, KV * g, 1, D)
    L = kv.shape[2]
    mask = (torch.arange(L, device=dev)[None, :]
            < c["lengths"][:, None])[:, None, None, :]
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kv, vv, attn_mask=mask, enable_gqa=True), 200)
    live_blocks = int(sum(-(-int(n) // bs) for n in lengths))
    item = 2
    nbytes = (2 * B * KV * g * D * item  # q in, out
              + 2 * live_blocks * bs * KV * D * item  # live K and V blocks
              + live_blocks * 4 + B * 4)  # live table entries, lengths
    ops = 4 * int(lengths.sum()) * KV * g * D
    bound_ms, by = bound(nbytes, ops, "bfloat16")
    log(f"  paged_gqa_decode_attn bf16 B={B} lengths={lengths.tolist()}: "
        f"{ms:.4f} ms; plain {plain_ms:.4f} ms; SDPA(gathered view) "
        f"{lib_ms:.4f} ms; bound {bound_ms:.5f} ms ({by})")
    return dict(name="paged_gqa_decode_attn", route="cuda",
                source="src/repro_torch/csrc/paged_decode_attn.cu",
                replaces="src/repro/kernels/paged_decode_attn.py:139",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms)


def time_glu(torch, dev, err):
    import torch.nn.functional as F
    from repro_torch.kernels import sparce_glu_mlp as sgm
    cfg = arch_config()
    rng = np.random.default_rng(6)
    bm, bf = 64, 128
    M, K, F_, N = ENGINE["slots"], cfg.d_model, cfg.d_ff, cfg.d_model

    def normal(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    # The main path's shapes and init scales (every stripe live).
    xp = F.pad(normal(M, K), (0, 0, 0, bm - M))
    wg, wi = normal(K, F_, scale=K ** -0.5), normal(K, F_, scale=K ** -0.5)
    wo = normal(F_, N, scale=F_ ** -0.5)
    run = lambda: sgm.sparce_glu_mlp_fused(  # noqa: E731
        xp, wg, wi, wo, block_m=bm, block_f=bf)
    ms = cuda_time_ms(run, 100)
    plain_ms = cuda_time_ms(lambda: sgm.sparce_glu_mlp_fused_plain(
        xp, wg, wi, wo, block_m=bm, block_f=bf), 20)
    lib_ms = cuda_time_ms(lambda: (F.silu(xp @ wg) * (xp @ wi)) @ wo, 200)
    _, bits = run()
    live = int((bits == 0).sum())
    live_stripes = int((bits == 0).any(dim=0).sum())
    item = 2
    nbytes = (xp.numel() * item + wg.numel() * item
              + live_stripes * (K * bf + bf * N) * item
              + bm * N * item + bits.numel() * 4)  # y as written: bm rows
    ops = 2 * bm * K * F_ + live * (2 * bm * K * bf + 2 * bm * bf * N)
    bound_ms, by = bound(nbytes, ops, "bfloat16")
    log(f"  sparce_glu_mlp_fused bf16 x={tuple(xp.shape)} (M={M} padded to "
        f"{bm}) K={K} F={F_} N={N}, {live} live tiles: {ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms; 3 matmuls + silu {lib_ms:.4f} ms; bound "
        f"{bound_ms:.5f} ms ({by})")
    return dict(name="sparce_glu_mlp_fused", route="cuda",
                source="src/repro_torch/csrc/sparce_glu_mlp.cu",
                replaces="src/repro/kernels/sparce_glu_mlp.py:150",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms)


def relu_decode_operands(torch, dev):
    """The relu MLP's decode-tick operands at full width in bf16: one row
    per slot, of which two are dead (zero rows, as the engine feeds
    them), init-scale weights; h = x @ w_in and a = relu(h) as the
    kernel mode computes them."""
    cfg = relu_config()
    rng = np.random.default_rng(10)
    M, K, F_, N = ENGINE["slots"], cfg.d_model, cfg.d_ff, cfg.d_model
    x = rng.standard_normal((M, K), dtype=np.float32)
    x[[0, M - 2]] = 0.0
    wi = rng.standard_normal((K, F_), dtype=np.float32) / np.sqrt(K)
    wo = rng.standard_normal((F_, N), dtype=np.float32) / np.sqrt(F_)
    x, wi, wo = (torch.from_numpy(a).to(dev, torch.bfloat16)
                 for a in (x, wi, wo))
    h = x @ wi
    return x, wi, wo, h, torch.relu(h)


def kernel_row(name, cu, replaces, err, ms, plain_ms, lib_ms, nbytes, ops,
               what):
    bound_ms, by = bound(nbytes, ops, "bfloat16")
    log(f"  {name} bf16 {what}: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"library {lib_ms:.4f} ms; bound {bound_ms:.5f} ms ({by}; "
        f"{nbytes} bytes, {ops} operations)")
    return dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{cu}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def time_mlp(torch, dev, err):
    from repro_torch.kernels import sparce_mlp as sm
    x, wi, wo, _, _ = relu_decode_operands(torch, dev)
    bf = SPARCE_BLOCKS["block_k"]
    kw = dict(block_m=1, block_f=bf)
    ms = cuda_time_ms(lambda: sm.sparce_mlp_fused(x, wi, wo, **kw), 200)
    plain_ms = cuda_time_ms(
        lambda: sm.sparce_mlp_fused_plain(x, wi, wo, **kw), 20)
    lib_ms = cuda_time_ms(lambda: torch.relu(x @ wi) @ wo, 200)
    _, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
    live = int((bits == 0).sum())
    live_stripes = int((bits == 0).any(dim=0).sum())
    M, K = x.shape
    F_, N = wo.shape
    nbytes = 2 * (x.numel() + wi.numel() + live_stripes * bf * N + M * N) \
        + 4 * bits.numel()
    ops = 2 * M * K * F_ + live * 2 * bf * N
    return kernel_row(
        "sparce_mlp_fused", "sparce_mlp.cu",
        "src/repro/kernels/sparce_mlp.py:111", err, ms, plain_ms, lib_ms,
        nbytes, ops, f"x={tuple(x.shape)} K={K} F={F_} N={N} block (1,{bf}),"
        f" {live} live tiles (relu(x@w_in)@w_out as the library call)")


def time_relu_bitmap(torch, dev, err):
    from repro_torch.kernels import relu_bitmap as rb
    _, _, _, h, _ = relu_decode_operands(torch, dev)
    bc = SPARCE_BLOCKS["block_k"]
    M, F_ = h.shape
    ms = cuda_time_ms(lambda: rb.relu_bitmap(h, block_r=1, block_c=bc), 200)
    plain_ms = cuda_time_ms(
        lambda: rb.relu_bitmap_plain(h, block_r=1, block_c=bc), 200)

    def library():
        y = torch.relu(h)
        return y, ~(y > 0).view(M, 1, F_ // bc, bc).any(3).any(1)

    lib_ms = cuda_time_ms(library, 200)
    nbytes = 2 * 2 * h.numel() + 4 * M * (F_ // bc)
    return kernel_row(
        "relu_bitmap", "relu_bitmap.cu", "src/repro/kernels/relu_bitmap.py:41",
        err, ms, plain_ms, lib_ms, nbytes, h.numel(),
        f"h={tuple(h.shape)} tile (1,{bc}) (torch.relu + tile-any as the "
        "library call)")


def time_gemm(torch, dev, err):
    from repro_torch.kernels import relu_bitmap as rb
    from repro_torch.kernels import sparce_gemm as sg
    _, _, wo, h, _ = relu_decode_operands(torch, dev)
    bk, bn = SPARCE_BLOCKS["block_k"], 128
    a, bits = rb.relu_bitmap(h, block_r=1, block_c=bk)
    kw = dict(block_m=1, block_k=bk, block_n=bn)
    ms = cuda_time_ms(lambda: sg.sparce_gemm_gated(a, wo, bits, **kw), 200)
    plain_ms = cuda_time_ms(
        lambda: sg.sparce_gemm_gated_plain(a, wo, bits, **kw), 20)
    lib_ms = cuda_time_ms(lambda: a @ wo, 200)
    M, K = a.shape
    N = wo.shape[1]
    live = int((bits == 0).sum())
    live_stripes = int((bits == 0).any(dim=0).sum())
    nbytes = 2 * (live * bk + live_stripes * bk * N + M * N) \
        + 4 * bits.numel()
    ops = live * 2 * bk * N
    return kernel_row(
        "sparce_gemm_gated", "sparce_gemm.cu",
        "src/repro/kernels/sparce_gemm.py:123", err, ms, plain_ms, lib_ms,
        nbytes, ops, f"a={tuple(a.shape)} @ w_out {tuple(wo.shape)}, lhs "
        f"tiles (1,{bk}), {live} live tiles (a@w_out as the library call)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated subset of phases to run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    # f32 products at full precision on the card, like the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    try:
        from repro_torch.kernels import _build
        log(gpu_name_and_power())
        t0 = time.perf_counter()
        _build.build()
        log(f"phase 1: built {len(_build.SOURCES)} kernels in "
            f"{time.perf_counter() - t0:.1f}s (sm_90a)")
        for name in _build.SOURCES:
            for line in _build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")
        errs = {}
        if 2 in phases:
            log("phase 2: kernels vs plain versions on the card")
            errs["paged_gqa_decode_attn"] = check_attention(torch, dev)
            errs["sparce_glu_mlp_fused"] = check_glu(torch, dev)
            errs["relu_bitmap"] = check_relu_bitmap(torch, dev)
            errs["sparce_gemm_gated"] = check_gemm(torch, dev)
            errs["sparce_mlp_fused"] = check_mlp(torch, dev)
        if 3 in phases:
            from repro_torch.core.sparse_ops import SparsityConfig
            log("phase 3: f32 full-width decode step, kernels vs plain")
            check_decode_step(torch, dev, arch_config(), SparsityConfig(
                enabled=True, mode="fused", gate_threshold=0.0,
                autotune=False), "glu fused")
            for mode in ("fused", "kernel"):
                check_decode_step(torch, dev, relu_config(), SparsityConfig(
                    enabled=True, mode=mode, autotune=False,
                    **SPARCE_BLOCKS), f"relu {mode}")
        rows = []
        if 4 in phases:
            log("phase 4: full-width bf16 gated-GLU engine")
            launches = run_glu_engine(torch, dev)
            rows += [time_attention(torch, dev,
                                    errs.get("paged_gqa_decode_attn")),
                     time_glu(torch, dev, errs.get("sparce_glu_mlp_fused"))]
            for row in rows:
                row["launches"] = launches[row["name"]]
        if 5 in phases:
            log("phase 5: full-width bf16 relu engine (--sparce), fused and "
                "kernel modes")
            launches = run_relu_engines(torch, dev)
            timers = (("sparce_mlp_fused", time_mlp, "fused"),
                      ("relu_bitmap", time_relu_bitmap, "kernel"),
                      ("sparce_gemm_gated", time_gemm, "kernel"))
            for name, timer, mode in timers:
                row = timer(torch, dev, errs.get(name))
                row["launches"] = launches[mode][name]
                rows.append(row)
        torch.cuda.synchronize()
    except Exception:  # noqa: BLE001 - report and fail the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
