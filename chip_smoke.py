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
     pool blocks (the null block among them), dead weight stripes and
     gated tiles, bits exactly;
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
     kernels' launch counts;
  6. the full-width bf16 DeepSeek-V3 engine (MLA absorbed decode out of
     the paged latent pool, MoE), 4 layers deep, on the same trace with
     the mixed budgets and its paged MLA kernel's launch count; then one
     f32 2-layer decode step (1 dense + 1 MoE layer) made from those
     weights, kernels on the card against plain versions on the CPU;
  7. the paper's evaluation path: the AlexNet GEMM table at its
     published shapes (batch 1, f32) for alexnet, deepcomp-alexnet and
     cifar10 under the plans the paper's Fig. 14 makes, each layer
     through ``ops.sparce_gemm`` (dense, lhs gated, lhs compacted, rhs
     gated and two-sided kernels) and the relu backward of its output,
     then ``launch.figures --figs 17,18,demo``, with the launch counts
     read around them; then each layer against its plain version and
     the masked oracle, with its time beside ``x @ w``'s.

After phases 4-7, each of the nine kernels' time at its path's shapes
beside its plain version, a library yardstick and its bound.

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
# matrix path: bf16 tensor cores; f32 outside them (the port runs f32
# products at full precision, TF32 off); split-TF32, the f32 route of
# the skipping GEMMs and the gated GLU, three TF32 tensor-core products
# per multiply-add at the TF32 peak of 495 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12,
                  "split-tf32": 495e12 / 3}

ARCH = "smollm-135m"
# DeepSeek-V3 serving (MLA + MoE) at its published widths, depth cut.
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_DEPTH = dict(num_layers=4)
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


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_time_ms(fn, iters: int = 50, names=None, repeats: int = 3):
    """Mean device ms per call of ``fn`` from ``torch.profiler``: for
    each kernel it launches (every kernel, or those whose name holds one
    of ``names``), the mean time of a launch times its launches per call
    (its count over ``iters`` calls, rounded, at least 1: every kernel
    seen is one the call launches), summed; the median of ``repeats``
    profiled windows. After a profiled engine run a window can lose many
    kernel records; the mean per launch survives that, the log reports
    it, and a window that saw none of the call's kernels is profiled
    again. Returns (ms, {kernel: ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    windows, partial = [], []
    for _ in range(4 * repeats):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        parts, counts = {}, {}
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or _dev_us(e) <= 0
                    or (names and not any(n in e.key for n in names))):
                continue
            key = next((n for n in names or () if n in e.key), e.key[:40])
            per_call = max(1, round(e.count / iters))
            counts[key] = counts.get(key, 0) + e.count
            parts[key] = (parts.get(key, 0.0)
                          + _dev_us(e) / 1e3 / e.count * per_call)
        if any(c % iters for c in counts.values()):
            partial.append(counts)
        if parts:
            windows.append((sum(parts.values()), parts))
        if len(windows) == repeats:
            break
    if partial:
        log(f"    profiler: {len(partial)} windows lost kernel records "
            f"(launches seen over {iters} calls: {partial})")
    if not windows:
        raise AssertionError("the profiler recorded no device time")
    windows.sort(key=lambda w: w[0])
    return windows[len(windows) // 2]


def graph_time_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device ms per call of ``fn`` without the profiler and without the
    host's per-call cost: ``iters`` calls captured in one CUDA graph,
    replayed between CUDA events; the median of ``repeats`` replays.
    Every kernel the call launches counts, with the gaps between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


# The kernels of a skipping GEMM call: the core (gated, compacted or
# two-sided), and the chunk reduction of a split-K call; every kernel a
# skipping plan of phase 7 runs.
GEMM_KERNELS = ("gated_gemm_kernel", "compacted_gemm_kernel",
                "gated_both_gemm_kernel", "chunk_reduce_kernel")
# The kernels of a gated-GLU call: the cluster kernel and the reduction
# over live stripes; of a fused relu MLP call, the same design's; of a
# paged MLA call, the chunk kernel and the merge of a slot's chunks; of a
# paged GQA call, the chunk kernel (which merges a slot's chunks in its
# last-arriving CTA); and the single kernel of each of the other calls.
GLU_KERNELS = ("glu_cluster_kernel", "stripe_reduce_kernel")
MLP_KERNELS = ("mlp_cluster_kernel", "stripe_reduce_kernel")
MLA_KERNELS = ("mla_chunk_kernel", "mla_combine_kernel")
GQA_KERNELS = ("gqa_chunk_kernel",)
RELU_KERNELS = ("relu_bitmap_kernel",)
RELU_BWD_KERNELS = ("relu_bwd_bitmap_kernel",)


def log_device_times(label, ms, run, lib_ms, library, names=GEMM_KERNELS):
    """A kernel call's device time (every kernel of ``names`` it
    launches) and its library call's, beside their CUDA-events times."""
    dev_ms, parts = device_time_ms(run, names=names)
    lib_dev_ms, _ = device_time_ms(library)
    split = ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
    log(f"  {label}: device {dev_ms:.4f} ms ({split}), events {ms:.4f} ms; "
        f"library device {lib_dev_ms:.4f} ms, events {lib_ms:.4f} ms")
    return dev_ms, lib_dev_ms


def log_device_witnesses(label, ms, run, lib_ms, library, names):
    """A kernel call's device time by both witnesses -- the profiler (the
    kernels of ``names``) and a replayed CUDA graph -- beside its library
    call's, and both calls' CUDA-events times. Returns (device ms, graph
    ms, library device ms, library graph ms)."""
    dev_ms, lib_dev_ms = log_device_times(label, ms, run, lib_ms, library,
                                          names=names)
    graph_ms, lib_graph_ms = graph_time_ms(run), graph_time_ms(library)
    log(f"  {label}: graph: kernel {graph_ms:.4f} ms, library "
        f"{lib_graph_ms:.4f} ms")
    return dev_ms, graph_ms, lib_dev_ms, lib_graph_ms


def log_kernel_resources(_build, name):
    """Registers and spills (ptxas) of each instantiation of the kernels
    of ``csrc/<name>.cu``; for the GEMM core's, also its dynamic shared
    memory (a function of the rows it serves)."""
    import ctypes
    import re
    i = ctypes.c_int
    smem = (_build.function("sparce_gemm", "sparce_gemm_smem_bytes", [i, i])
            if name == "sparce_gemm" else None)
    entry = spill = None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and entry is not None:
            k = re.search(
                r"([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f)(?:Li(\d+)E)?",
                entry)
            if k is None:
                log(f"  {name}: {line.strip()}; {spill}")
                continue
            dtype = "bf16" if k.group(2) != "f" else "f32"
            what = f"{k.group(1)}<{dtype}"
            if k.group(3) and name == "paged_mla_decode_attn":
                what += f", {8 * int(k.group(3))} latent columns a warp>"
            elif k.group(3) and name == "paged_decode_attn":
                what += f", head dim up to {16 * int(k.group(3))}>"
            elif k.group(3):
                nt8 = int(k.group(3))
                what += f", {8 * nt8} rows>"
                if smem is not None:
                    what += (f", {smem(int(dtype == 'bf16'), nt8)} bytes of "
                             "dynamic smem")
            else:
                what += ">"
            used = line.split("Used", 1)[1].strip()
            log(f"  {name}: {what}: {used}; {spill}")


def bound(bytes_moved: float, ops: float, path: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[path]
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
        if not same_bits(torch, pda.paged_gqa_decode_attn(*args), got):
            raise AssertionError(f"{name}: a second call differs")
        log(f"  {name}: a second call equal bit for bit -> ok")
    return errs[torch.bfloat16]


# ------------------------------------------------------------------ MLA
# DeepSeek-V3's absorbed-decode widths: 128 heads, a 512-wide latent and
# 64-wide rope keys per row; scores scale by (nope + rope) ** -0.5.
MLA_DIMS = dict(h=128, r=512, rope=64)
MLA_SCALE = (128 + 64) ** -0.5


def mla_case(torch, dev, dtype, seed, *, B=8, h=128, r=512, rope=64, bs=16,
             max_blocks=32, lengths=None):
    """Latent pools, tables and ragged lengths (0, a block edge, one
    past the table's reach); dead table entries name spare blocks."""
    rng = np.random.default_rng(seed)
    reach = max_blocks * bs
    if lengths is None:
        lengths = [0, 1, bs, bs + 1, 100, reach - 1, reach, reach + 40][:B]
    live = [min(-(-n // bs), max_blocks) for n in lengths]
    nb = sum(live) + 1 + 16  # null block, live blocks, 16 spare blocks
    ids = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, max_blocks), np.int32)
    nxt = 0
    for b in range(B):
        tables[b, : live[b]] = ids[nxt: nxt + live[b]]
        nxt += live[b]
    spare = ids[nxt:]
    for b in range(B):
        tables[b, live[b]:] = rng.choice(spare, max_blocks - live[b])
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return dict(q_lat=mk(B, h, r), q_rope=mk(B, h, rope), ckv=mk(nb, bs, r),
                kr=mk(nb, bs, rope), tables=torch.from_numpy(tables).to(dev),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
                live_ids=set(ids[:nxt].tolist()), nb=nb)


def check_mla(torch, dev):
    """The MLA kernel against its plain version and the gathered-view
    oracle, at the full decode width, at lengths on the chunk edges (E *
    bs, E * bs + 1, the table's reach, past it, 0; slots whose trailing
    chunks are all empty) and at a small ragged shape (heads not a
    multiple of the kernel's 32 per block, a latent narrower than a
    warp, a rope below one MMA depth), in f32 and bf16; zeros for a
    length-0 slot; a second call equal bit for bit; NaN poison in the
    null block and in every block past a slot's live count."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_decode_attn as pda
    from repro_torch.kernels import ref as kref
    tols = {
        torch.float32: (1e-4, 1e-4, "f32 sums over 576-term dots and the "
                        "rows in another order"),
        torch.bfloat16: (2e-2, 2e-2, "bf16 p rounded against a running "
                         "max in the kernel, against the final max in the "
                         "plain version; bf16 output rounding"),
    }
    bs = ENGINE["block_size"]
    max_blocks = ENGINE["max_len"] // bs
    grid = pda.mla_grid(8, MLA_DIMS["h"], max_blocks, bs)
    edge, reach = grid["entries"] * bs, max_blocks * bs
    shapes = {"full width": dict(MLA_DIMS),
              "chunk edges": dict(MLA_DIMS, lengths=[
                  edge, edge + 1, reach, reach + 1, 0, edge - 1, 2 * edge,
                  1]),
              "small": dict(B=5, h=12, r=16, rope=8, bs=4, max_blocks=6,
                            lengths=[0, 4, 7, 24, 30])}
    if grid["ctas"] < 132:
        raise AssertionError(f"MLA launch of {grid['ctas']} CTAs at the "
                             "engine shape")
    log(f"  paged_mla_decode_attn launch at the DeepSeek decode shape (8 "
        f"slots, {MLA_DIMS['h']} heads, {max_blocks} table entries of "
        f"{bs} rows): {grid['ctas']} CTAs = {grid['chunks']} chunks of "
        f"{grid['entries']} entries x {grid['head_groups']} head groups x "
        "8 slots")
    err_main = None
    for dtype, (atol, rtol, why) in tols.items():
        for label, kw in shapes.items():
            c = mla_case(torch, dev, dtype, seed=11, **kw)
            args = (c["q_lat"], c["q_rope"], c["ckv"], c["kr"], c["tables"],
                    c["lengths"])
            got = pda.paged_mla_decode_attn(*args, scale=MLA_SCALE)
            want = pda.paged_mla_decode_attn_plain(*args, scale=MLA_SCALE)
            torch.cuda.synchronize()
            name = f"paged_mla_decode_attn {str(dtype)[6:]} {label}"
            err = check_close(name, got, want, atol=atol, rtol=rtol, why=why)
            if dtype == torch.bfloat16 and label == "full width":
                err_main = err
            live = c["lengths"] > 0
            oracle = kref.paged_mla_decode_attn_ref(*args, scale=MLA_SCALE)
            check_close(name + " vs gather oracle (live slots)", got[live],
                        oracle[live], atol=atol, rtol=rtol, why=why)
            wrapped = kops.paged_mla_decode_attn(*args, scale=MLA_SCALE)
            if not torch.equal(wrapped, got):
                raise AssertionError(
                    f"{name}: the clamping wrapper differs from the kernel")
            again = pda.paged_mla_decode_attn(*args, scale=MLA_SCALE)
            if not same_bits(torch, again, got):
                raise AssertionError(f"{name}: a second call differs")
            if not bool((got[~live] == 0).all()):
                raise AssertionError("a length-0 slot did not produce zeros")
            dead = [i for i in range(c["nb"]) if i not in c["live_ids"]]
            ckv, kr = c["ckv"].clone(), c["kr"].clone()
            ckv[dead] = float("nan")
            kr[dead] = float("nan")
            poisoned = pda.paged_mla_decode_attn(
                c["q_lat"], c["q_rope"], ckv, kr, c["tables"], c["lengths"],
                scale=MLA_SCALE)
            torch.cuda.synchronize()
            if not (torch.isfinite(poisoned).all()
                    and torch.equal(poisoned, got)):
                raise AssertionError(
                    f"{name}: NaN-poisoned dead blocks reached the output")
            log(f"  {name}: {len(dead)} NaN-poisoned blocks (null block "
                "and every block past the live counts) never read -> ok")
    return err_main


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
        # Decode slots, a ragged prefill bucket (2 row tiles) and a full
        # one, unpadded: the kernel masks rows past M itself.
        for M in (8, 100, 256):
            for tau in (0.0, 0.05):
                x, wg, wi, wo = glu_case(torch, dev, dtype, seed=2, M=M)
                y, bits = sgm.sparce_glu_mlp_fused(
                    x, wg, wi, wo, block_m=bm, block_f=bf, tau=tau)
                y0, bits0 = sgm.sparce_glu_mlp_fused_plain(
                    x, wg, wi, wo, block_m=bm, block_f=bf, tau=tau)
                torch.cuda.synchronize()
                name = (f"sparce_glu_mlp_fused {str(dtype)[6:]} M={M} "
                        f"tau={tau}")
                if not torch.equal(bits, bits0):
                    raise AssertionError(f"{name}: bits differ")
                y1, bits1 = sgm.sparce_glu_mlp_fused(
                    x, wg, wi, wo, block_m=bm, block_f=bf, tau=tau)
                if not (same_bits(torch, y1, y)
                        and torch.equal(bits1, bits)):
                    raise AssertionError(f"{name}: a second call differs")
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
                    x, wg, wi2, wo2, block_m=bm, block_f=bf, tau=tau)
                torch.cuda.synchronize()
                if not (torch.isfinite(y2).all() and torch.equal(y2, y)
                        and torch.equal(bits2, bits)):
                    raise AssertionError(
                        f"{name}: NaN-poisoned dead stripes reached y")
        # The wrapper the model calls: 8 rows under a 64-row tile, nothing
        # padded.
        x, wg, wi, wo = glu_case(torch, dev, dtype, seed=3, M=8)
        y, bmp = kops.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=bm,
                                           block_f=bf)
        y0, bmp0 = kops.sparce_glu_mlp_fused(x.cpu(), wg.cpu(), wi.cpu(),
                                             wo.cpu(), block_m=bm,
                                             block_f=bf)
        if not torch.equal(bmp.bits.cpu(), bmp0.bits):
            raise AssertionError("ops wrapper: bits differ from the CPU")
        grid = sgm.kernel_grid(8, x.shape[1], wg.shape[1], wo.shape[1],
                               block_m=bm, block_f=bf, dtype=dtype)
        if grid["ctas"] <= wg.shape[1] // bf:
            raise AssertionError(f"decode grid of {grid['ctas']} CTAs")
        log(f"  ops.sparce_glu_mlp_fused {str(dtype)[6:]} (M=8 unpadded, "
            f"block_m {bm}): bits equal to the CPU plain version's; the "
            f"kernel's launch: {grid['ctas']} CTAs in clusters of "
            f"{grid['cluster']}, {grid['rows']} rows per chunk, "
            f"{grid['smem']} bytes of dynamic smem -> ok")
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
    """Nonnegative x with the row tile of row M // 2 dead (with one row
    tile, its rows from M // 2 zero); w_in's stripe 2 negative so it is
    dead in every row tile; init-scale weights."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((M, K), dtype=np.float32))
    if M > bm:
        t = (M // 2) // bm
        x[t * bm:(t + 1) * bm] = 0.0
    else:
        x[M // 2:] = 0.0
    wi = rng.standard_normal((K, F), dtype=np.float32) / np.sqrt(K)
    wi[:, 2 * bf: 3 * bf] = -np.abs(wi[:, 2 * bf: 3 * bf])
    wo = rng.standard_normal((F, N), dtype=np.float32) / np.sqrt(F)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    return t(x), t(wi), t(wo)


def check_relu_bitmap(torch, dev):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import relu_bitmap as rb
    for dtype in (torch.float32, torch.bfloat16):
        # The relu paths' shapes, then ragged ones the kernel takes
        # unpadded: rows not 16-byte multiples, a ragged tile taller than
        # a row.
        cases = [((M, 1536), (bm, 128)) for M, bm in RELU_CASES] + [
            ((7, 300), (1, 128)), ((130, 200), (64, 128))]
        for (M, C), (bm, bc) in cases:
            rng = np.random.default_rng(M + bm)
            h = rng.standard_normal((M, C), dtype=np.float32)
            h[: bm, :bc] = -1.0  # no element > 0
            t = M // 2 // bm  # the row tile of row M // 2: all zero
            h[t * bm: (t + 1) * bm] = 0.0
            h[-1, -1] = np.nan  # NaN and -0.0 pass through
            h[0, -1] = -0.0
            ht = torch.from_numpy(h).to(dev, dtype)
            y, bits = rb.relu_bitmap(ht, block_r=bm, block_c=bc)
            y0, bits0 = rb.relu_bitmap_plain(ht, block_r=bm, block_c=bc)
            torch.cuda.synchronize()
            name = (f"relu_bitmap {str(dtype)[6:]} {M}x{C} "
                    f"block=({bm},{bc})")
            if not (same_bits(torch, y, y0) and torch.equal(bits, bits0)):
                raise AssertionError(f"{name}: y or bits differ")
            if not (bool(bits[0, 0]) and bool(bits[M // 2 // bm].all())):
                raise AssertionError(f"{name}: dead tiles not flagged")
            log(f"  {name}: y and bits equal the plain version's bit for "
                f"bit ({int(bits.sum())} dead tiles) -> ok")
        # The unpadded wrapper: 8 rows over 64-row tiles.
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
    """The fused relu MLP kernel against its plain version: bits exactly,
    y within tolerance, at the relu cases, unpadded ragged M and F, f32
    and bf16, relu and relu2; a second call equal bit for bit; NaN in
    the w_out rows of the stripes dead in every row tile, and (per row)
    in a stripe live in one row tile and dead in another, never reaching
    a row whose tile is dead there."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_mlp as sm
    bf = 128
    err_main = None
    # (M, F, block_m): the relu cases at F 1536, then ragged M and F.
    cases = [(M, 1536, bm) for M, bm in RELU_CASES] + [
        (37, 1000, 1), (37, 1000, 64), (100, 1000, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol, why = RELU_TOLS[str(dtype)[6:]]
        for M, F_, bm in cases:
            for act in ("relu", "relu2"):
                x, wi, wo = mlp_case(torch, dev, dtype, seed=M + bm, M=M,
                                     bm=bm, F=F_)
                kw = dict(block_m=bm, block_f=bf, act=act)
                y, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
                y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **kw)
                torch.cuda.synchronize()
                name = (f"sparce_mlp_fused {str(dtype)[6:]} {act} M={M} "
                        f"F={F_} block_m={bm}")
                if not torch.equal(bits, bits0):
                    raise AssertionError(f"{name}: bits differ")
                dead_t = (M // 2) // bm
                if not (bool(bits[:, 2].all())
                        and (M <= bm or bool(bits[dead_t].all()))):
                    raise AssertionError(f"{name}: dead tiles not flagged")
                err = check_close(f"{name} ({int(bits.sum())} dead tiles)",
                                  y, y0, atol=atol, rtol=rtol, why=why)
                if dtype == torch.bfloat16 and M == 8 and act == "relu":
                    err_main = err
                y1, bits1 = sm.sparce_mlp_fused(x, wi, wo, **kw)
                if not (same_bits(torch, y1, y)
                        and torch.equal(bits1, bits)):
                    raise AssertionError(f"{name}: a second call differs")
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
                if M > bm:  # a dead row tile beside live ones
                    per_row_poison(torch, sm, name, x, wi, wo, y, bits, kw)
        # The wrapper the model calls: 8 rows under a 64-row tile, nothing
        # padded.
        x, wi, wo = mlp_case(torch, dev, dtype, seed=5, M=8, bm=1)
        y, bmp = kops.sparce_mlp_fused(x, wi, wo, block_m=64, block_f=bf)
        y0, bmp0 = kops.sparce_mlp_fused(x.cpu(), wi.cpu(), wo.cpu(),
                                         block_m=64, block_f=bf)
        if not torch.equal(bmp.bits.cpu(), bmp0.bits):
            raise AssertionError("ops wrapper: bits differ from the CPU")
        for M, bm in ((8, 64), (8, 1)):
            grid = sm.kernel_grid(M, x.shape[1], wi.shape[1], wo.shape[1],
                                  block_m=bm, block_f=bf, dtype=dtype)
            if grid["ctas"] <= wi.shape[1] // bf:
                raise AssertionError(f"decode grid of {grid['ctas']} CTAs")
        log(f"  ops.sparce_mlp_fused {str(dtype)[6:]} (M=8 unpadded, "
            f"block_m 64): bits equal to the CPU plain version's; the "
            f"kernel's launch at block_m 1: {grid['ctas']} CTAs in "
            f"clusters of {grid['cluster']}, {grid['rows']} rows per chunk, "
            f"{grid['smem']} bytes of dynamic smem -> ok")
    log("  sparce_mlp_fused: NaN-poisoned dead w_out stripes never read, "
        "per-row poison never added to a dead row, second calls equal "
        "(every case above) -> ok")
    return err_main


def per_row_poison(torch, sm, name, x, wi, wo, y, bits, kw):
    """NaN in the w_out rows of a stripe live in some row tile and dead
    in another: the dead tile's rows keep their finite output, equal to
    the unpoisoned run's; a live row does take the poison."""
    bm, bf = kw["block_m"], kw["block_f"]
    mixed = [f for f in range(bits.shape[1])
             if bool(bits[:, f].any()) and not bool(bits[:, f].all())]
    if not mixed:
        raise AssertionError(f"{name}: no stripe live in one row tile and "
                             "dead in another")
    f = mixed[0]
    wo2 = wo.clone()
    wo2[f * bf:(f + 1) * bf] = float("nan")
    y2, bits2 = sm.sparce_mlp_fused(x, wi, wo2, **kw)
    torch.cuda.synchronize()
    rows = torch.arange(x.shape[0], device=x.device)
    dead = bits[rows // bm, f].bool()
    if not (torch.equal(bits2, bits) and torch.isfinite(y2[dead]).all()
            and torch.equal(y2[dead], y[dead])
            and torch.isnan(y2[~dead]).any()):
        raise AssertionError(f"{name}: the per-row NaN poison of stripe {f} "
                             "reached a row whose tile is dead in it")


# ------------------------------------- the evaluation path's GEMM kernels
# (M, K, N, bm, bk, bn): AlexNet's conv4 and fc6 under alexnet's compacted
# plans and deepcomp's two-sided fc6 and conv5 plans, 168- and 256-row
# tiles with ragged M, K and N, and a per-row tile.
EVAL_GEMM_CASES = (
    (169, 3456, 384, 8, 128, 256), (1, 9216, 4096, 8, 128, 256),
    (1, 9216, 4096, 8, 128, 128), (169, 3456, 256, 8, 128, 256),
    (169, 2304, 384, 168, 128, 128), (300, 1000, 250, 256, 128, 128),
    (37, 640, 200, 1, 128, 128))
EVAL_TOLS = {
    "float32": (1e-4, 1e-4, "f32 sums over up to 9216 terms of init-scale "
                "products in another order"),
    "bfloat16": (2e-2, 2e-2, "bf16 output rounding after f32 sums in "
                 "another order"),
}


def eval_case(torch, dev, dtype, M, K, N, bm, bk, bn, seed):
    """x, init-scale w and random lhs and rhs bit grids (k tile 1 dead for
    every row tile; with several row tiles the last has nnz == 0)."""
    from repro_torch.kernels import sparce_gemm as sg
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32) / np.sqrt(K)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    lbits = (rng.random(sg.bit_grid(M, K, N, gate="lhs", **kw)) < 0.6
             ).astype(np.int32)
    rbits = (rng.random(sg.bit_grid(M, K, N, gate="rhs", **kw)) < 0.5
             ).astype(np.int32)
    lbits[:, 1] = 1
    if lbits.shape[0] > 1:
        lbits[-1] = 1
        lbits[0, 0] = 0
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(x).to(dtype), t(w).to(dtype), t(lbits), t(rbits), lbits, rbits


def poison(torch, x, w, lbits, rbits, bm, bk, bn, *, both):
    """NaN in every x tile with lhs bit 1, in every w k-stripe dropped for
    all row tiles, and (two-sided) in every w tile with rhs bit 1."""
    x2, w2 = x.clone(), w.clone()
    for i, j in zip(*np.nonzero(lbits)):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")
    for k in np.nonzero(lbits.all(axis=0))[0]:
        w2[k * bk:(k + 1) * bk] = float("nan")
    if both:
        for i, j in zip(*np.nonzero(rbits)):
            w2[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = float("nan")
    return x2, w2


def same_bits(torch, a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(view), b.view(view))


def check_compacted(torch, dev):
    """The compacted kernel against its plain version and, bit for bit,
    the gated kernel on the same bits; nnz == 0 row tiles give exact
    zeros; NaN-poisoned dead tiles and unlisted stripes never read."""
    from repro_torch.kernels import sparce_gemm as sg
    err_main = None
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol, why = EVAL_TOLS[str(dtype)[6:]]
        for case in EVAL_GEMM_CASES:
            M, K, N, bm, bk, bn = case
            x, w, lb, _, lbits, rbits = eval_case(torch, dev, dtype, *case,
                                                  seed=M + K)
            kw = dict(block_m=bm, block_k=bk, block_n=bn)
            y = sg.sparce_gemm_compacted(x, w, lb, **kw)
            yg = sg.sparce_gemm_gated(x, w, lb, **kw)
            y0 = sg.sparce_gemm_compacted_plain(x, w, lb, **kw)
            torch.cuda.synchronize()
            name = (f"sparce_gemm_compacted {str(dtype)[6:]} {M}x{K}x{N} "
                    f"blocks ({bm},{bk},{bn})")
            err = check_close(name, y, y0, atol=atol, rtol=rtol, why=why)
            if dtype == torch.float32 and case == EVAL_GEMM_CASES[0]:
                err_main = err
            if not same_bits(torch, y, yg):
                raise AssertionError(f"{name}: differs from the gated "
                                     "kernel on the same bits")
            if lbits.shape[0] > 1 and not bool(
                    (y[(lbits.shape[0] - 1) * bm:] == 0).all()):
                raise AssertionError(f"{name}: nnz == 0 tile not zero")
            x2, w2 = poison(torch, x, w, lbits, rbits, bm, bk, bn,
                            both=False)
            y2 = sg.sparce_gemm_compacted(x2, w2, lb, **kw)
            torch.cuda.synchronize()
            if not (torch.isfinite(y2).all() and torch.equal(y2, y)):
                raise AssertionError(f"{name}: NaN-poisoned dead tiles "
                                     "reached y")
    log("  sparce_gemm_compacted: equal to the gated kernel bit for bit, "
        "nnz == 0 row tiles exact zeros, NaN-poisoned dead x tiles and "
        "unlisted w stripes never read (every case above) -> ok")
    return err_main


def check_both(torch, dev):
    """The two-sided kernel against its plain version and the masked
    oracle with both masks; NaN-poisoned dropped tiles never read."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sparce_gemm as sg
    err_main = None
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol, why = EVAL_TOLS[str(dtype)[6:]]
        for case in EVAL_GEMM_CASES:
            M, K, N, bm, bk, bn = case
            x, w, lb, rb_, lbits, rbits = eval_case(torch, dev, dtype, *case,
                                                    seed=M + K + 1)
            kw = dict(block_m=bm, block_k=bk, block_n=bn)
            y = sg.sparce_gemm_gated_both(x, w, lb, rb_, **kw)
            y0 = sg.sparce_gemm_gated_both_plain(x, w, lb, rb_, **kw)
            ref = kref.sparce_gemm_ref(x, w, bits_lhs=lb, bits_rhs=rb_, **kw)
            torch.cuda.synchronize()
            name = (f"sparce_gemm_gated_both {str(dtype)[6:]} {M}x{K}x{N} "
                    f"blocks ({bm},{bk},{bn})")
            err = check_close(name, y, y0, atol=atol, rtol=rtol, why=why)
            check_close(name + " vs sparce_gemm_ref (both masks)", y, ref,
                        atol=atol, rtol=rtol, why=why)
            if dtype == torch.float32 and case == EVAL_GEMM_CASES[2]:
                err_main = err
            x2, w2 = poison(torch, x, w, lbits, rbits, bm, bk, bn, both=True)
            y2 = sg.sparce_gemm_gated_both(x2, w2, lb, rb_, **kw)
            y3 = sg.sparce_gemm_gated_both(x, w, lb, rb_, **kw)
            torch.cuda.synchronize()
            if not (torch.isfinite(y2).all() and torch.equal(y2, y)):
                raise AssertionError(f"{name}: NaN-poisoned dropped tiles "
                                     "reached y")
            if not same_bits(torch, y3, y):
                raise AssertionError(f"{name}: a second call differs")
            # With every rhs bit 0 it is the lhs-gated kernel's walk.
            open_ = sg.sparce_gemm_gated_both(x, w, lb, torch.zeros_like(rb_),
                                              **kw)
            if not same_bits(torch, open_,
                             sg.sparce_gemm_gated(x, w, lb, gate="lhs", **kw)):
                raise AssertionError(f"{name}: with rhs bits 0 it differs "
                                     "from the lhs-gated kernel")
    log("  sparce_gemm_gated_both: NaN-poisoned dropped x and w tiles "
        "never read, a second call equal bit for bit, equal to the "
        "lhs-gated kernel when every rhs bit is 0 (every case above) -> ok")
    return err_main


def check_relu_bwd(torch, dev):
    """gx and bits equal the plain version's exactly, at the relu decode
    tick's shape and two more: NaN in g where x <= 0 never reaches gx, a
    NaN where x > 0 passes (bit 0), -0.0 counts as zero. Returns the
    largest |gx - plain| over the non-NaN positions of every case."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import relu_bitmap as rb
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, (br, bc) in (((8, 1536), (1, 128)),
                                ((256, 1536), (1, 128)),
                                ((128, 256), (64, 128))):
            rng = np.random.default_rng(shape[0] + br)
            x = rng.standard_normal(shape, dtype=np.float32)
            g = rng.standard_normal(shape, dtype=np.float32)
            x[:br, :bc] = -1.0
            g[:br, :bc] = np.nan
            g[:br, bc:2 * bc] = -0.0
            x[-br:, -bc:], g[-br:, -bc:] = 1.0, 0.0
            g[-1, -1] = np.nan
            xt, gt = (torch.from_numpy(a).to(dev, dtype) for a in (x, g))
            gx, bits = rb.relu_bwd_bitmap(xt, gt, block_r=br, block_c=bc)
            gx0, bits0 = rb.relu_bwd_bitmap_plain(xt, gt, block_r=br,
                                                  block_c=bc)
            torch.cuda.synchronize()
            name = (f"relu_bwd_bitmap {str(dtype)[6:]} {shape} tile "
                    f"({br},{bc})")
            if not (torch.equal(bits, bits0) and torch.equal(
                    torch.nan_to_num(gx, 7.0), torch.nan_to_num(gx0, 7.0))):
                raise AssertionError(f"{name}: gx or bits differ")
            if not (bits[0, 0] == 1 and bits[0, 1] == 1
                    and bits[-1, -1] == 0
                    and int(torch.isnan(gx).sum()) == 1):
                raise AssertionError(f"{name}: NaN or -0.0 mishandled")
            ok = ~torch.isnan(gx0)
            err = max(err, float((gx[ok].float() - gx0[ok].float()).abs()
                                 .max()))
            log(f"  {name}: gx and bits equal the plain version's "
                f"({int(bits.sum())} dead tiles) -> ok")
        xt = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (10, 300), dtype=np.float32)).to(dev, dtype)
        gx, bmp = kops.relu_bwd_with_bitmap(xt, xt, (8, 128))
        gx0, bmp0 = kops.relu_bwd_with_bitmap(xt.cpu(), xt.cpu(), (8, 128))
        if not (torch.equal(gx.cpu(), gx0)
                and torch.equal(bmp.bits.cpu(), bmp0.bits)):
            raise AssertionError("ops.relu_bwd_with_bitmap differs from the "
                                 "CPU")
    return err


# ------------------------------------------------------- decode-step parity
def decode_state(torch, cfg, dev, seed, *, B=8, max_blocks=8, bs=16):
    """Random pools, ragged live lengths, dead slots, block tables."""
    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(seed)
    lengths = [0, 3, 16, 31, 64, 100, 0, 127]
    nb = B * max_blocks + 1
    caches = model_lib.init_paged_caches(cfg, B, nb, bs, device=dev)
    for c in caches.values():  # every stack: "stack" (and "dense_stack")
        c.k.copy_(torch.from_numpy(rng.standard_normal(
            tuple(c.k.shape), dtype=np.float32)))
        c.v.copy_(torch.from_numpy(rng.standard_normal(
            tuple(c.v.shape), dtype=np.float32)))
        c.length.copy_(torch.tensor(lengths, dtype=torch.int32)[
            None, :].expand(c.length.shape[0], B))
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
    compare_decode_step(torch, dev, cfg, params, label,
                        why="30 layers of f32 sums in another order")


def compare_decode_step(torch, dev, cfg, params, label, *, why):
    """``serving_decode_step`` with ``params`` (on the card: the kernels)
    against the same step on a CPU copy (the plain versions)."""
    from repro_torch.models import model as model_lib
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
                lc[live], atol=atol, rtol=rtol, why=why)
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
            "paged_mla_decode_attn": pda.paged_mla_decode_attn,
            "sparce_glu_mlp_fused": sgm.sparce_glu_mlp_fused,
            "sparce_mlp_fused": sm.sparce_mlp_fused,
            "relu_bitmap": rb.relu_bitmap,
            "sparce_gemm_gated": sg.sparce_gemm_gated,
            "sparce_gemm_compacted": sg.sparce_gemm_compacted,
            "sparce_gemm_gated_both": sg.sparce_gemm_gated_both,
            "relu_bwd_bitmap": rb.relu_bwd_bitmap}


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


def deepseek_config():
    """DeepSeek-V3 at its published widths, cut to 4 layers: the 3 dense
    MLA + GLU layers (first_k_dense as published) and 1 MLA + MoE layer."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(DEEPSEEK), **DEEPSEEK_DEPTH)


def run_deepseek(torch, dev):
    """The full-width bf16 DeepSeek-V3 engine (paged MLA decode, MoE) on
    the mixed-budget trace, then an f32 2-layer decode step (1 dense +
    1 MoE layer, made from the engine's weights) with the kernels on the
    card against the plain versions on the CPU. Returns the engine's
    launches."""
    from repro_torch.core import sasa
    from repro_torch.core.sparse_ops import SparsityConfig
    cfg = deepseek_config()
    plan = sasa.plan_glu_mlp_cached(
        ENGINE["slots"], cfg.d_model, cfg.d_ff, cfg.d_model,
        dtype="bfloat16", block_m=64, block_f=128, block_n=128)
    log(f"  dense-layer GLU at d_model {cfg.d_model}, d_ff {cfg.d_ff}: the "
        f"planner picks {plan.variant!r} for a decode tick of "
        f"{ENGINE['slots']} rows")
    torch.cuda.reset_peak_memory_stats()
    params = full_width_params(torch, cfg, dev)
    sp = SparsityConfig(enabled=True, mode="fused", gate_threshold=0.0,
                        autotune=False)
    _, launches = run_engine(torch, dev, cfg, params, sp, "deepseek",
                             ("paged_mla_decode_attn",), mixed=True)
    log(f"  deepseek: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # The f32 step's weights: the engine's first dense and first MoE
    # layer, upcast on the card one leaf at a time (the rest is freed
    # first, so the card never holds both copies of a leaf for long).
    import dataclasses
    cfg2 = dataclasses.replace(cfg, num_layers=2, first_k_dense=1,
                               dtype="float32", sparsity=sp)
    params["dense_stack"] = params["dense_stack"][:1]
    params["stack"] = params["stack"][:1]
    upcast_in_place(torch, params)
    log(f"  deepseek f32 2-layer step: "
        f"{sum(p.numel() for p in _leaves(params))} f32 values on the card")
    compare_decode_step(torch, dev, cfg2, params, "deepseek 2-layer",
                        why="2 layers of f32 sums in another order; the "
                        "MoE layer's 256 experts at 8 rows each")
    params.clear()
    torch.cuda.empty_cache()
    return launches


def upcast_in_place(torch, tree):
    """Every tensor of a param tree to f32, leaf by leaf, releasing each
    low-precision leaf's memory before the next upcast."""
    keys = list(tree) if isinstance(tree, dict) else range(len(tree))
    for k in keys:
        if isinstance(tree[k], (dict, list)):
            upcast_in_place(torch, tree[k])
        else:
            tree[k] = tree[k].float()  # drops the only other reference
            torch.cuda.empty_cache()


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

    # Device-side events only (kernels, memcpy/memset); the CPU-side
    # aten ops that launched them would count the same time again.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _dev_us(e) > 0]
    total_us = sum(_dev_us(e) for e in events)
    if not events:
        log("  profiler: no device time recorded")
        return
    log(f"  {label} profiler ({int(srv.metrics.ticks)} ticks, "
        f"{int(srv.metrics.admitted)} prefills): device busy "
        f"{total_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({total_us / 1e4 / wall:.1f}%)")
    for e in sorted(events, key=_dev_us, reverse=True)[:10]:
        log(f"    {_dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:70]}")


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
def trace_lengths():
    """The 8 slots' lengths ``time_attention`` times: drawn from the
    engine trace's range of prompt plus new tokens."""
    rng = np.random.default_rng(5)
    return rng.integers(ENGINE["prompt_lo"],
                        ENGINE["prompt_hi"] + ENGINE["max_new"],
                        ENGINE["slots"]).tolist()


def gqa_library(torch, c):
    """The GQA yardstick on an ``attn_case``: SDPA over the gathered full
    view (the gather done outside the call)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref as kref
    B, KV, g, D = c["q"].shape
    kv = kref.gather_pool_view(c["k"], c["tables"]).transpose(1, 2)
    vv = kref.gather_pool_view(c["v"], c["tables"]).transpose(1, 2)
    kv, vv = kv.contiguous(), vv.contiguous()
    qh = c["q"].reshape(B, KV * g, 1, D)
    mask = (torch.arange(kv.shape[2], device=kv.device)[None, :]
            < c["lengths"][:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qh, kv, vv, attn_mask=mask, enable_gqa=True)


def time_attention(torch, dev, err):
    """The GQA kernel at the GLU engine's decode shape (8 slots of the
    trace's lengths, 3 KV heads of 3 query rows, head dim 64, 16-row
    blocks, 32 entries, bf16): events, device time by both witnesses
    beside SDPA's over the gathered view, the launch; then every slot at
    512 rows (the full table), logged the same way."""
    from repro_torch.kernels import paged_decode_attn as pda
    B, KV, g, D, bs = ENGINE["slots"], 3, 3, 64, ENGINE["block_size"]
    max_blocks = ENGINE["max_len"] // bs
    lengths = np.asarray(trace_lengths())

    def case(lens):
        c = attn_case(torch, dev, torch.bfloat16, seed=5,
                      lengths=lens.tolist(), max_blocks=max_blocks)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
        library = gqa_library(torch, c)
        walk = pda.gqa_chunk_walk(c["tables"].cpu().numpy(), lens, bs, KV)
        grid = pda.gqa_grid(B, KV, max_blocks, bs)
        log(f"  paged_gqa_decode_attn launch: {grid['ctas']} CTAs of "
            f"{grid['warps']} warps ({grid['chunks']} chunks of "
            f"{grid['entries']} entries x {grid['head_groups']} head groups "
            f"x {B} slots), {sum(len(e) > 0 for w in walk for e in w)} of "
            "them with a live chunk")
        return args, library

    args, library = case(lengths)
    run = lambda: pda.paged_gqa_decode_attn(*args)  # noqa: E731
    ms = cuda_time_ms(run, 200)
    plain_ms = cuda_time_ms(lambda: pda.paged_gqa_decode_attn_plain(*args),
                            10, warmup=1)
    lib_ms = cuda_time_ms(library, 200)
    log_device_witnesses("paged_gqa_decode_attn decode", ms, run, lib_ms,
                         library, GQA_KERNELS)
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
    full_args, full_library = case(np.full(B, max_blocks * bs))
    full = lambda: pda.paged_gqa_decode_attn(*full_args)  # noqa: E731
    log_device_witnesses("paged_gqa_decode_attn full table (512 rows a "
                         "slot)", cuda_time_ms(full, 200), full,
                         cuda_time_ms(full_library, 200), full_library,
                         GQA_KERNELS)
    return dict(name="paged_gqa_decode_attn", route="cuda",
                source="src/repro_torch/csrc/paged_decode_attn.cu",
                replaces="src/repro/kernels/paged_decode_attn.py:139",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms)


def time_mla(torch, dev, err):
    """The MLA kernel at the DeepSeek engine's decode shapes: 8 slots of
    the trace's lengths, 128 heads, 512-wide latents, 64-wide rope keys,
    16-row blocks, bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode_attn as pda
    from repro_torch.kernels import ref as kref
    rng = np.random.default_rng(12)
    B, bs = ENGINE["slots"], ENGINE["block_size"]
    h, r, rope = MLA_DIMS["h"], MLA_DIMS["r"], MLA_DIMS["rope"]
    max_blocks = ENGINE["max_len"] // bs
    lengths = rng.integers(ENGINE["prompt_lo"],
                           ENGINE["prompt_hi"] + ENGINE["max_new"], B)
    c = mla_case(torch, dev, torch.bfloat16, seed=12, B=B, bs=bs,
                 max_blocks=max_blocks, lengths=lengths.tolist(), **MLA_DIMS)
    args = (c["q_lat"], c["q_rope"], c["ckv"], c["kr"], c["tables"],
            c["lengths"])
    run = lambda: pda.paged_mla_decode_attn(  # noqa: E731
        *args, scale=MLA_SCALE)
    ms = cuda_time_ms(run, 200)
    plain_ms = cuda_time_ms(
        lambda: pda.paged_mla_decode_attn_plain(*args, scale=MLA_SCALE), 10,
        warmup=1)
    # Yardstick: SDPA with one KV head over the gathered full view (the
    # gather and concatenations done outside): the h query heads are the
    # query rows, keys are [ckv, kr], values ckv.
    cc = kref.gather_pool_view(c["ckv"], c["tables"])
    cr = kref.gather_pool_view(c["kr"], c["tables"])
    qk = torch.cat([c["q_lat"], c["q_rope"]], -1)[:, None].contiguous()
    kk = torch.cat([cc, cr], -1)[:, None].contiguous()
    vv = cc[:, None].contiguous()
    L = cc.shape[1]
    mask = (torch.arange(L, device=dev)[None, :]
            < c["lengths"][:, None])[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qk, kk, vv, attn_mask=mask, scale=MLA_SCALE)
    lib_ms = cuda_time_ms(library, 200)
    log_device_witnesses("paged_mla_decode_attn decode", ms, run, lib_ms,
                         library, MLA_KERNELS)
    grid = pda.mla_grid(B, h, max_blocks, bs)
    walk = pda.mla_chunk_walk(c["tables"].cpu().numpy(), lengths, bs, h)
    live_ctas = grid["head_groups"] * sum(
        len(e) > 0 for chunks in walk for e in chunks)
    log(f"  paged_mla_decode_attn launch: {grid['ctas']} CTAs "
        f"({grid['chunks']} chunks of {grid['entries']} entries x "
        f"{grid['head_groups']} head groups x {B} slots), {live_ctas} of "
        "them with a live chunk")
    live_blocks = int(sum(-(-int(n) // bs) for n in lengths))
    item = 2
    nbytes = (B * h * (2 * r + rope) * item  # q_lat, q_rope in; out
              + live_blocks * bs * (r + rope) * item  # live latent blocks
              + live_blocks * 4 + B * 4)  # live table entries, lengths
    ops = int(lengths.sum()) * (2 * h * (r + rope) + 2 * h * r)
    bound_ms, by = bound(nbytes, ops, "bfloat16")
    log(f"  paged_mla_decode_attn bf16 B={B} h={h} r={r} rope={rope} "
        f"lengths={lengths.tolist()}: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"SDPA(gathered view, one KV head) {lib_ms:.4f} ms; bound "
        f"{bound_ms:.5f} ms ({by}; {nbytes} bytes, {ops} operations)")
    return dict(name="paged_mla_decode_attn", route="cuda",
                source="src/repro_torch/csrc/paged_mla_decode_attn.cu",
                replaces="src/repro/kernels/paged_decode_attn.py:247",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms)


def time_glu(torch, dev, err):
    """The gated GLU at the decode tick's real operands (8 rows, init
    scales, every stripe live), unpadded as the engine calls it: events
    time, device time by two witnesses (the profiler by kernel name, a
    replayed CUDA graph), each beside the library call's; then the
    256-row prefill bucket, logged."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_glu_mlp as sgm
    cfg = arch_config()
    rng = np.random.default_rng(6)
    bm, bf = 64, 128
    M, K, F_, N = ENGINE["slots"], cfg.d_model, cfg.d_ff, cfg.d_model

    def normal(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    x = normal(M, K)
    wg, wi = normal(K, F_, scale=K ** -0.5), normal(K, F_, scale=K ** -0.5)
    wo = normal(F_, N, scale=F_ ** -0.5)
    run = lambda: kops.sparce_glu_mlp_fused(  # noqa: E731
        x, wg, wi, wo, block_m=bm, block_f=bf)
    library = lambda: (F.silu(x @ wg) * (x @ wi)) @ wo  # noqa: E731
    ms = cuda_time_ms(run, 100)
    plain_ms = cuda_time_ms(lambda: sgm.sparce_glu_mlp_fused_plain(
        x, wg, wi, wo, block_m=bm, block_f=bf), 20)
    lib_ms = cuda_time_ms(library, 200)
    log_device_witnesses("sparce_glu_mlp_fused decode", ms, run, lib_ms,
                         library, GLU_KERNELS)
    _, bmp = run()
    bits = bmp.bits
    live = int((bits == 0).sum())
    live_stripes = int((bits == 0).any(dim=0).sum())
    item = 2
    # Each input byte once (x, the gate weights, the live stripes of w_in
    # and w_out), y and the bits written once; the products of the real
    # rows only.
    nbytes = (x.numel() * item + wg.numel() * item
              + live_stripes * (K * bf + bf * N) * item
              + M * N * item + bits.numel() * 4)
    ops = 2 * M * K * F_ + live_stripes * (2 * M * K * bf + 2 * M * bf * N)
    bound_ms, by = bound(nbytes, ops, "bfloat16")
    grid = sgm.kernel_grid(M, K, F_, N, block_m=bm, block_f=bf,
                           dtype=torch.bfloat16)
    log(f"  sparce_glu_mlp_fused bf16 x={tuple(x.shape)} (unpadded, "
        f"block_m {bm}) K={K} F={F_} N={N}, {live} live tiles, "
        f"{grid['ctas']} CTAs: {ms:.4f} ms; plain {plain_ms:.4f} ms; 3 "
        f"matmuls + silu {lib_ms:.4f} ms; bound {bound_ms:.5f} ms ({by}; "
        f"{nbytes} bytes, {ops} operations)")
    xp = normal(256, K)
    run_p = lambda: kops.sparce_glu_mlp_fused(  # noqa: E731
        xp, wg, wi, wo, block_m=bm, block_f=bf)
    lib_p = lambda: (F.silu(xp @ wg) * (xp @ wi)) @ wo  # noqa: E731
    y, bmp_p = run_p()
    y0, bits0 = sgm.sparce_glu_mlp_fused_plain(xp, wg, wi, wo, block_m=bm,
                                               block_f=bf)
    if not torch.equal(bmp_p.bits, bits0):
        raise AssertionError("sparce_glu_mlp_fused prefill: bits differ")
    check_close("sparce_glu_mlp_fused prefill 256 rows", y, y0, atol=2e-2,
                rtol=2e-2, why="bf16 roundings of g, h, a and y after f32 "
                "sums in another order")
    log_device_times("sparce_glu_mlp_fused prefill 256 rows",
                     cuda_time_ms(run_p, 100), run_p,
                     cuda_time_ms(lib_p, 100), lib_p, names=GLU_KERNELS)
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
               what, dtype="bfloat16", path=None):
    """A kernels-line row; ``path`` (default ``dtype``) names the peak
    of :data:`PEAK_OPS_PER_S` the operations bound is taken at."""
    path = path or dtype
    bound_ms, by = bound(nbytes, ops, path)
    tag = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    log(f"  {name} {tag} {what}: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"library {lib_ms:.4f} ms; bound {bound_ms:.5f} ms ({by}; "
        f"{nbytes} bytes, {ops} operations at the {path} peak)")
    return dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{cu}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)


def time_mlp(torch, dev, err):
    """The fused relu MLP at the relu decode tick's operands (events,
    and device time by both witnesses beside the library call's), then
    at a 256-row prefill bucket with per-row tiles, held against its
    plain version and logged."""
    from repro_torch.kernels import sparce_mlp as sm
    x, wi, wo, _, _ = relu_decode_operands(torch, dev)
    bf = SPARCE_BLOCKS["block_k"]
    kw = dict(block_m=1, block_f=bf)
    run = lambda: sm.sparce_mlp_fused(x, wi, wo, **kw)  # noqa: E731
    library = lambda: torch.relu(x @ wi) @ wo  # noqa: E731
    ms = cuda_time_ms(run, 200)
    plain_ms = cuda_time_ms(
        lambda: sm.sparce_mlp_fused_plain(x, wi, wo, **kw), 20)
    lib_ms = cuda_time_ms(library, 200)
    log_device_witnesses("sparce_mlp_fused decode", ms, run, lib_ms,
                         library, MLP_KERNELS)
    _, bits = run()
    live = int((bits == 0).sum())
    live_stripes = int((bits == 0).any(dim=0).sum())
    M, K = x.shape
    F_, N = wo.shape
    nbytes = 2 * (x.numel() + wi.numel() + live_stripes * bf * N + M * N) \
        + 4 * bits.numel()
    ops = 2 * M * K * F_ + live * 2 * bf * N
    grid = sm.kernel_grid(M, K, F_, N, dtype=x.dtype, **kw)
    row = kernel_row(
        "sparce_mlp_fused", "sparce_mlp.cu",
        "src/repro/kernels/sparce_mlp.py:111", err, ms, plain_ms, lib_ms,
        nbytes, ops, f"x={tuple(x.shape)} K={K} F={F_} N={N} block (1,{bf}),"
        f" {live} live tiles, {grid['ctas']} CTAs (relu(x@w_in)@w_out as "
        "the library call)")
    # The relu prefill's shape: one 256-row bucket, per-row tiles.
    xp = torch.from_numpy(np.abs(np.random.default_rng(13).standard_normal(
        (256, K), dtype=np.float32))).to(dev, x.dtype)
    run_p = lambda: sm.sparce_mlp_fused(xp, wi, wo, **kw)  # noqa: E731
    lib_p = lambda: torch.relu(xp @ wi) @ wo  # noqa: E731
    y, bits_p = run_p()
    y0, bits0 = sm.sparce_mlp_fused_plain(xp, wi, wo, **kw)
    if not torch.equal(bits_p, bits0):
        raise AssertionError("sparce_mlp_fused prefill: bits differ")
    atol, rtol, why = RELU_TOLS["bfloat16"]
    check_close("sparce_mlp_fused prefill 256 rows", y, y0, atol=atol,
                rtol=rtol, why=why)
    log_device_witnesses("sparce_mlp_fused prefill 256 rows",
                         cuda_time_ms(run_p, 100), run_p,
                         cuda_time_ms(lib_p, 100), lib_p, MLP_KERNELS)
    return row


def relu_library(torch, x, bc):
    """relu_bitmap's yardstick: ``torch.relu`` and a tile-any over
    one-row tiles of bc columns (C a multiple of bc)."""
    R, C = x.shape

    def library():
        y = torch.relu(x)
        return y, ~(y > 0).view(R, 1, C // bc, bc).any(3).any(1)

    return library


def time_relu_bitmap(torch, dev, err):
    """relu_bitmap at the relu decode tick's h (8 x 1536, tile (1, 128),
    bf16): events, device time by both witnesses beside the library
    call's; then a 256-row prefill bucket the same way, and one (1, 128)
    tile by both witnesses (the kernel's launch floor), each logged with
    its launch."""
    from repro_torch.kernels import relu_bitmap as rb
    _, _, _, h, _ = relu_decode_operands(torch, dev)
    bc = SPARCE_BLOCKS["block_k"]
    M, F_ = h.shape

    def calls(x):
        R, C = x.shape
        grid = rb.relu_bitmap_grid(R, C, 1, bc, x.dtype)
        log(f"  relu_bitmap launch at {R} x {C}: {grid['ctas']} CTAs of up "
            f"to {grid['tiles_per_cta']} tiles ({rb.RELU_THREADS} threads)")
        return (lambda: rb.relu_bitmap(x, block_r=1, block_c=bc),
                relu_library(torch, x, bc))

    run, library = calls(h)
    ms = cuda_time_ms(run, 200)
    plain_ms = cuda_time_ms(
        lambda: rb.relu_bitmap_plain(h, block_r=1, block_c=bc), 200)
    lib_ms = cuda_time_ms(library, 200)
    log_device_witnesses("relu_bitmap decode", ms, run, lib_ms, library,
                         RELU_KERNELS)
    hp = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (256, F_), dtype=np.float32)).to(dev, h.dtype)
    run_p, lib_p = calls(hp)
    y, bits = run_p()
    y0, bits0 = rb.relu_bitmap_plain(hp, block_r=1, block_c=bc)
    if not (same_bits(torch, y, y0) and torch.equal(bits, bits0)):
        raise AssertionError("relu_bitmap prefill: y or bits differ")
    log_device_witnesses("relu_bitmap prefill 256 rows",
                         cuda_time_ms(run_p, 200), run_p,
                         cuda_time_ms(lib_p, 200), lib_p, RELU_KERNELS)
    run_1, _ = calls(h[:1, :bc].contiguous())
    tile_ms, _ = device_time_ms(run_1, names=RELU_KERNELS)
    log(f"  relu_bitmap one (1,{bc}) tile (the launch floor): device "
        f"{tile_ms:.4f} ms, graph {graph_time_ms(run_1):.4f} ms")
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
    log_device_times("sparce_gemm_gated relu decode", ms,
                     lambda: sg.sparce_gemm_gated(a, wo, bits, **kw), lib_ms,
                     lambda: a @ wo)
    row = gated_row(a, wo, bits, kw, err, ms, plain_ms, lib_ms, "decode")
    # The relu prefill's shape (one 256-row bucket), logged: per-row and
    # 64-row tiles, each output held against the plain version.
    hp = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (256, h.shape[1]), dtype=np.float32)).to(dev, h.dtype)
    atol, rtol, why = RELU_TOLS["bfloat16"]
    for bm in (1, 64):
        ap, bp = rb.relu_bitmap(hp, block_r=bm, block_c=bk)
        kwp = dict(kw, block_m=bm)
        run = lambda: sg.sparce_gemm_gated(ap, wo, bp, **kwp)  # noqa: E731
        plain = lambda: sg.sparce_gemm_gated_plain(  # noqa: E731
            ap, wo, bp, **kwp)
        err_p = check_close(f"sparce_gemm_gated relu prefill block_m {bm}",
                            run(), plain(), atol=atol, rtol=rtol, why=why)
        ms_p = cuda_time_ms(run, 100)
        lib_p = cuda_time_ms(lambda: ap @ wo, 100)
        log_device_times(f"sparce_gemm_gated relu prefill block_m {bm}",
                         ms_p, run, lib_p, lambda: ap @ wo)
        gated_row(ap, wo, bp, kwp, err_p, ms_p,
                  cuda_time_ms(plain, 3, warmup=1), lib_p, "prefill")
    return row


def gated_row(a, wo, bits, kw, err, ms, plain_ms, lib_ms, what):
    """The kernels-line row of the gated kernel (lhs gate, bf16) at one
    relu MLP shape, with its bound from these bits."""
    bm, bk = kw["block_m"], kw["block_k"]
    M, K = a.shape
    N = wo.shape[1]
    live = int((bits == 0).sum())
    live_stripes = int((bits == 0).any(dim=0).sum())
    nbytes = 2 * (live * bm * bk + live_stripes * bk * N + M * N) \
        + 4 * bits.numel()
    ops = live * 2 * bm * bk * N
    return kernel_row(
        "sparce_gemm_gated", "sparce_gemm.cu",
        "src/repro/kernels/sparce_gemm.py:123", err, ms, plain_ms, lib_ms,
        nbytes, ops, f"{what} a={tuple(a.shape)} @ w_out {tuple(wo.shape)},"
        f" lhs tiles ({bm},{bk}), {live} live tiles (a@w_out as the library"
        " call)")


# ------------------------------------------- phase 7: the paper's figures
EVAL_BENCHES = ("alexnet", "deepcomp-alexnet", "cifar10")


def eval_layers(torch, dev, bench, seed):
    """The AlexNet layer table at its published shapes (batch 1, f32) for
    ``bench``: features from ``random_sparse`` in 8 x 128 clusters at the
    layer's scaled sparsity, normal weights block-pruned (the plan's rhs
    tiles) at the deep-compression sparsity, the plan fig14 makes, and
    the bitmaps. Yields (layer, plan, x, w, lhs bitmap, rhs bitmap)."""
    from repro_torch.core import sprf
    from repro_torch.launch import figures
    gen = torch.Generator(device=dev).manual_seed(seed)
    for layer, act, ws in figures.bench_layers(bench):
        plan = figures.bench_plan(layer, act, ws)
        x = sprf.random_sparse(gen, (layer.m, layer.k), act, cluster=(8, 128))
        w = torch.randn((layer.k, layer.n), generator=gen, device=dev)
        if ws:
            w = sprf.prune_weights(w, ws, block=plan.block_rhs)
        yield (layer, plan, x, w, sprf.compute_bitmap(x, plan.block_lhs),
               sprf.compute_bitmap(w, plan.block_rhs))


def gemm_plain(torch, plan, x, w, lb, rbm):
    """The plain version of the kernel ``ops.sparce_gemm`` runs for
    ``plan`` (the bit grids are already at the kernels' shapes)."""
    from repro_torch.kernels import sparce_gemm as sg
    kw = dict(block_m=plan.block_m, block_k=plan.block_k,
              block_n=plan.block_n)
    if plan.gate == "none" or plan.variant == "dense":
        return x.float() @ w.float()
    if plan.gate == "both":
        return sg.sparce_gemm_gated_both_plain(x, w, lb.bits, rbm.bits, **kw)
    if plan.gate == "lhs" and plan.variant == "compacted":
        return sg.sparce_gemm_compacted_plain(x, w, lb.bits, **kw)
    bits = lb.bits if plan.gate == "lhs" else rbm.bits
    return sg.sparce_gemm_gated_plain(x, w, bits, gate=plan.gate, **kw)


def run_eval_path(torch, dev):
    """Phase 7's main path: every layer of the three benchmarks through
    ``ops.sparce_gemm`` under its plan, the relu backward of each
    layer's output through ``ops.relu_bwd_with_bitmap`` (the error bitmap
    the backward GEMMs gate on), then ``launch.figures --figs
    17,18,demo`` on the card (which holds each of its GEMM outputs
    against the masked oracle and stops on a disagreement). Returns
    ({kernel: launches in the run}, {(bench, layer): output}, {(bench,
    layer): (y, g, block, gx, error bitmap)})."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import figures
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    outs, bwd = {}, {}
    gen = torch.Generator(device=dev).manual_seed(99)
    for i, bench in enumerate(EVAL_BENCHES):
        for layer, plan, x, w, lb, rbm in eval_layers(torch, dev, bench, i):
            y = kops.sparce_gemm(x, w, plan, lhs_bitmap=lb, rhs_bitmap=rbm)
            outs[bench, layer.name] = y
            g = torch.randn(y.shape, generator=gen, device=dev)
            block = (plan.block_m, 128)
            gx, ebits = kops.relu_bwd_with_bitmap(y, g, block)
            bwd[bench, layer.name] = (y, g, block, gx, ebits)
    rows = figures.run(["17", "18", "demo"], device=dev, seed=0)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log("  launches on the path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    for name in ("sparce_gemm_compacted", "sparce_gemm_gated_both",
                 "sparce_gemm_gated", "relu_bwd_bitmap"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the path")
    for name, us, derived in rows:
        if not np.isfinite(us) or not derived:
            raise AssertionError(f"figure row {name}: {us} {derived!r}")
        if "max_err_vs_dense=" in derived:
            err = float(derived.split("max_err_vs_dense=")[1].split(";")[0])
            if not err < 1e-3:
                raise AssertionError(f"figure row {name}: {derived}")
    log("  launch.figures: every GEMM output of figs 17, 18 and demo held "
        "against ref.sparce_gemm_ref with the same bits -> ok")
    return launches, outs, bwd


def check_relu_bwd_path(torch, bwd):
    """Each main-path relu backward against its plain version on the card,
    on the same inputs padded as ``ops.relu_bwd_with_bitmap`` pads them:
    bits equal, gx equal (NaN in the same places). Returns the largest
    |gx - plain| over the non-NaN positions."""
    from repro_torch.kernels import relu_bitmap as rb
    pad = torch.nn.functional.pad
    err, dead = 0.0, {}
    for (bench, name), (y, g, (br, bc), gx, ebits) in bwd.items():
        r, c = y.shape
        pr, pc = -(-r // br) * br, -(-c // bc) * bc
        gx0, bits0 = rb.relu_bwd_bitmap_plain(
            pad(y, (0, pc - c, 0, pr - r)).contiguous(),
            pad(g, (0, pc - c, 0, pr - r)).contiguous(), block_r=br,
            block_c=bc)
        gx0 = gx0[:r, :c]
        what = f"relu_bwd_with_bitmap {bench}/{name} {(r, c)} tile {(br, bc)}"
        if not (torch.equal(ebits.bits, bits0) and torch.equal(
                torch.nan_to_num(gx, 7.0), torch.nan_to_num(gx0, 7.0))):
            raise AssertionError(f"{what}: gx or bits differ from the plain "
                                 "version")
        ok = ~torch.isnan(gx0)
        err = max(err, float((gx[ok] - gx0[ok]).abs().max())
                  if bool(ok.any()) else 0.0)
        dead[f"{bench}/{name}"] = round(float(ebits.bits.float().mean()), 4)
    log(f"  relu backward on every layer's output: gx and bits equal the "
        f"plain version's; error-tile sparsity per layer: {dead} -> ok")
    return err


# The layers whose timings make the kernels-line rows (compacted at
# alexnet conv4 (169x3456x384) and fc6 (1x9216x4096), the two-sided gate
# at deepcomp-alexnet fc6) or are logged beside them (the gated kernel
# at alexnet conv2, lhs, and deepcomp-alexnet conv4, rhs).
ROW_LAYERS = (("alexnet", "conv4"), ("alexnet", "fc6"),
              ("deepcomp-alexnet", "fc6"), ("alexnet", "conv2"),
              ("deepcomp-alexnet", "conv4"))


def check_eval_path(torch, dev, outs):
    """Each layer's main-path output against its plain version on the
    card and the masked oracle; per layer the plan, the measured
    tile-skip fraction and the times of the kernel, its plain version
    and ``x @ w`` (the :data:`ROW_LAYERS` at the kernels line's iteration
    count), then the device time of the kernel and of ``x @ w`` from the
    profiler and, as a second witness, from a replayed CUDA graph; per
    benchmark the sum of kernel ms over ``x @ w`` ms, by events, by
    profiler device time and by graph time.
    Returns {layer of ROW_LAYERS: (plan, x, w, lhs bitmap, rhs bitmap,
    ms, plain ms, x@w ms)}."""
    from repro_torch.core import sasa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    atol, rtol = 1e-3, 1e-4
    why = ("f32 sums over up to 9216 terms of N(0, 1) products (outputs "
           "~1e2) in another order")
    keep = {}
    for i, bench in enumerate(EVAL_BENCHES):
        sums = [0.0] * 6
        for layer, plan, x, w, lb, rbm in eval_layers(torch, dev, bench, i):
            y = outs[bench, layer.name]
            y0 = gemm_plain(torch, plan, x, w, lb, rbm)
            ref = kref.sparce_gemm_ref(
                x, w, block_m=plan.block_m, block_k=plan.block_k,
                block_n=plan.block_n,
                bits_lhs=lb.bits if plan.gate in ("lhs", "both") else None,
                bits_rhs=rbm.bits if plan.gate in ("rhs", "both") else None)
            name = f"{bench}/{layer.name}"
            check_close(f"{name} vs plain", y, y0, atol=atol, rtol=rtol,
                        why=why)
            check_close(f"{name} vs sparce_gemm_ref", y, ref, atol=atol,
                        rtol=rtol, why=why)
            row = (bench, layer.name) in ROW_LAYERS
            iters = 100 if row else 20
            run = lambda: kops.sparce_gemm(  # noqa: E731
                x, w, plan, lhs_bitmap=lb, rhs_bitmap=rbm)
            ms = cuda_time_ms(run, iters)
            plain_ms = cuda_time_ms(
                lambda: gemm_plain(torch, plan, x, w, lb, rbm),
                5 if row else 3, warmup=1)
            dense_ms = cuda_time_ms(lambda: x @ w, iters)
            dense = plan.gate == "none" or plan.variant == "dense"
            dev_ms, parts = device_time_ms(
                run, names=None if dense else GEMM_KERNELS)
            dense_dev_ms, _ = device_time_ms(lambda: x @ w)
            graph_ms = graph_time_ms(run)
            dense_graph_ms = graph_time_ms(lambda: x @ w)
            for i_sum, v in enumerate((ms, dense_ms, dev_ms, dense_dev_ms,
                                       graph_ms, dense_graph_ms)):
                sums[i_sum] += v
            dropped, total = sasa.dropped_tile_products(plan, lb.bits,
                                                        rbm.bits)
            split = ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            log(f"  {name} {layer.m}x{layer.k}x{layer.n}: gate={plan.gate} "
                f"variant={plan.variant} blocks=({plan.block_m},"
                f"{plan.block_k},{plan.block_n}); tile products skipped "
                f"{dropped}/{total} = {dropped / total:.4f}; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, x@w {dense_ms:.4f} "
                f"ms; device: kernel {dev_ms:.4f} ms ({split}), x@w "
                f"{dense_dev_ms:.4f} ms; graph: kernel {graph_ms:.4f} ms, "
                f"x@w {dense_graph_ms:.4f} ms")
            if row:
                keep[bench, layer.name] = (plan, x, w, lb, rbm, ms, plain_ms,
                                           dense_ms)
        log(f"  {bench}: sum of kernel ms / sum of x@w ms = "
            f"{sums[0]:.4f} / {sums[1]:.4f} = {sums[0] / sums[1]:.3f}; "
            f"device: {sums[2]:.4f} / {sums[3]:.4f} = "
            f"{sums[2] / sums[3]:.3f}; graph: {sums[4]:.4f} / "
            f"{sums[5]:.4f} = {sums[4] / sums[5]:.3f}")
    return keep


def gemm_bytes_ops(plan, x, w, lb, rbm):
    """Bytes and operations the plan's skipping GEMM needs on these bits:
    each live x tile and each w tile some live product uses read once,
    y written once, the bit grids read; 2 flops per multiply-add of each
    live tile product."""
    M, K = x.shape
    N = w.shape[1]
    bm, bk, bn = plan.block_m, plan.block_k, plan.block_n
    lbits = lb.bits.bool().cpu().numpy()
    rbits = rbm.bits.bool().cpu().numpy()
    gm, gk, gn = lbits.shape[0], lbits.shape[1], rbits.shape[1]
    rows = np.minimum(bm, M - np.arange(gm) * bm)
    depth = np.minimum(bk, K - np.arange(gk) * bk)
    cols = np.minimum(bn, N - np.arange(gn) * bn)
    live = ~lbits[:, :, None] if plan.gate == "lhs" else \
        ~(lbits[:, :, None] | rbits[None])
    live = np.broadcast_to(live, (gm, gk, gn))
    x_live = live.any(axis=2)  # (gm, gk) x tiles some product reads
    w_live = live.any(axis=0)  # (gk, gn)
    item = x.element_size()
    nbytes = (item * (rows[:, None] * depth[None] * x_live).sum()
              + item * (depth[:, None] * cols[None] * w_live).sum()
              + item * M * N + 4 * lb.bits.numel()
              + (4 * rbm.bits.numel() if plan.gate == "both" else 0))
    ops = 2 * (rows[:, None, None] * depth[None, :, None]
               * cols[None, None, :] * live).sum()
    return int(nbytes), int(ops)


def eval_gemm_row(name, replaces, err, shapes, launches):
    """The kernels-line row of a GEMM kernel of phase 7 from the layer
    timings ``check_eval_path`` took: the first of ``shapes`` makes the
    row, the rest are logged. All three skipping kernels run f32 as
    split-TF32."""
    path = "split-tf32"
    row = None
    for key, (plan, x, w, lb, rbm, ms, plain_ms, lib_ms) in shapes:
        nbytes, ops = gemm_bytes_ops(plan, x, w, lb, rbm)
        r = kernel_row(
            name, "sparce_gemm.cu", replaces, err, ms, plain_ms, lib_ms,
            nbytes, ops, f"{'/'.join(key)} {tuple(x.shape)} @ "
            f"{tuple(w.shape)} blocks ({plan.block_m},{plan.block_k},"
            f"{plan.block_n}) (x@w as the library call)", dtype="float32",
            path=path)
        row = row or r
    row["launches"] = launches[name]
    return row


def time_relu_bwd(torch, dev, err, launches):
    """The relu backward at the relu decode tick's shape and tile: bf16
    (8, 1536), tile (1, 128); x the pre-activation, g normal."""
    from repro_torch.kernels import relu_bitmap as rb
    _, _, _, h, _ = relu_decode_operands(torch, dev)
    g = torch.randn(h.shape, device=dev).to(h.dtype)
    bc = SPARCE_BLOCKS["block_k"]
    M, F_ = h.shape
    ms = cuda_time_ms(lambda: rb.relu_bwd_bitmap(h, g, block_r=1,
                                                 block_c=bc), 200)
    plain_ms = cuda_time_ms(lambda: rb.relu_bwd_bitmap_plain(
        h, g, block_r=1, block_c=bc), 200)

    def library():
        gx = torch.where(h > 0, g, torch.zeros_like(g))
        return gx, ~(gx != 0).view(M, 1, F_ // bc, bc).any(3).any(1)

    lib_ms = cuda_time_ms(library, 200)
    log_device_witnesses(
        "relu_bwd_bitmap decode", ms,
        lambda: rb.relu_bwd_bitmap(h, g, block_r=1, block_c=bc), lib_ms,
        library, RELU_BWD_KERNELS)
    nbytes = 3 * 2 * h.numel() + 4 * M * (F_ // bc)
    row = kernel_row(
        "relu_bwd_bitmap", "relu_bitmap.cu",
        "src/repro/kernels/relu_bitmap.py:70", err, ms, plain_ms, lib_ms,
        nbytes, h.numel(), f"x=g={tuple(h.shape)} tile (1,{bc}) (torch.where "
        "+ tile-any as the library call)")
    row["launches"] = launches["relu_bwd_bitmap"]
    return row


def run_phase7(torch, dev, errs):
    launches, outs, bwd = run_eval_path(torch, dev)
    bwd_err = check_relu_bwd_path(torch, bwd)
    keep = check_eval_path(torch, dev, outs)
    eval_gemm_row("sparce_gemm_gated", "src/repro/kernels/sparce_gemm.py:123",
                  errs.get("sparce_gemm_gated"),
                  [(k, keep[k]) for k in ROW_LAYERS[3:]], launches)
    return [
        eval_gemm_row(
            "sparce_gemm_compacted", "src/repro/kernels/sparce_gemm.py:215",
            errs.get("sparce_gemm_compacted"),
            [(k, keep[k]) for k in ROW_LAYERS[:2]], launches),
        eval_gemm_row(
            "sparce_gemm_gated_both", "src/repro/kernels/sparce_gemm.py:170",
            errs.get("sparce_gemm_gated_both"),
            [(ROW_LAYERS[2], keep[ROW_LAYERS[2]])], launches),
        time_relu_bwd(torch, dev, max(errs.get("relu_bwd_bitmap", 0.0),
                                      bwd_err), launches),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
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
            log_kernel_resources(_build, name)
        errs = {}
        if 2 in phases:
            log("phase 2: kernels vs plain versions on the card")
            errs["paged_gqa_decode_attn"] = check_attention(torch, dev)
            errs["sparce_glu_mlp_fused"] = check_glu(torch, dev)
            errs["relu_bitmap"] = check_relu_bitmap(torch, dev)
            errs["sparce_gemm_gated"] = check_gemm(torch, dev)
            errs["sparce_mlp_fused"] = check_mlp(torch, dev)
            errs["paged_mla_decode_attn"] = check_mla(torch, dev)
            errs["sparce_gemm_compacted"] = check_compacted(torch, dev)
            errs["sparce_gemm_gated_both"] = check_both(torch, dev)
            errs["relu_bwd_bitmap"] = check_relu_bwd(torch, dev)
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
        if 6 in phases:
            log("phase 6: full-width bf16 DeepSeek-V3 engine (MLA + MoE, "
                f"{DEEPSEEK_DEPTH['num_layers']} layers), then an f32 "
                "2-layer decode step, kernels vs plain")
            launches = run_deepseek(torch, dev)
            row = time_mla(torch, dev, errs.get("paged_mla_decode_attn"))
            row["launches"] = launches["paged_mla_decode_attn"]
            rows.append(row)
        if 7 in phases:
            log("phase 7: the paper's evaluation path: the AlexNet GEMM "
                "table at its published shapes (f32) under fig14's plans, "
                "then launch.figures --figs 17,18,demo")
            t0 = time.perf_counter()
            rows += run_phase7(torch, dev, errs)
            log(f"phase 7: {time.perf_counter() - t0:.1f}s")
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
