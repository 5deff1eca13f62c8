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
     the masked oracle, with its time beside ``x @ w``'s;
  8. the full-width bf16 gated-GLU engine with the prefix cache
     (``ServeConfig(prefix_cache=True)``) on a trace of 16 prompts behind
     one shared 128-token prefix plus a byte-identical re-prompt (the
     copy-on-write case), served with the cache off and on: equal ticks,
     decode tokens, decode skip and attention block counters, prefix
     counters equal a count made on the host from the prompts, fewer
     prefill tokens, only the index holding blocks afterwards, and its
     kernels' launch counts read around the cache-on run; then f32
     2-layer greedy streams at full width equal with the cache off and
     on. Phase 2 holds the paged GQA kernel over such aliased tables;
  9. the live engine: (a) ``Server.serve_trace`` of a seeded open-loop
     trace (52 requests: Poisson arrivals, a burst, a shared prefix,
     priorities with TTFT deadlines, max_ticks deadlines) on the full-width bf16 GLU engine
     under a TTFT/ITL SLO with preemption, a bounded queue and a seeded
     fault plan, twice: equal schedules, every uid completed, failed or
     shed once, preemption, shedding, SLO defers and faults all seen, a
     clean pool; ms per tick, the virtual TTFT/ITL percentiles and the
     GQA and GLU launch counts; (b) the same trace on the f32 2-layer
     relu engine (``mode="kernel"``) at full width, kernels on the card
     against plain versions on the CPU: equal token streams, schedules
     and metrics, a preempted request restored; (c) ``AsyncServer``:
     two client threads submit 24 requests at wall-clock Poisson gaps, a
     third streams every handle, a live and a queued request are
     cancelled, then ``shutdown``: streams equal results, the wall-clock
     TTFT and inter-token gap percentiles in ms;
 10. the contiguous KV layout (``kv_block_size=0``; the ssm and hybrid
     families always): phase 4's engine and trace on contiguous caches
     (the gather path), its ticks, decode tokens and skip counters equal
     to phase 4's; ``mamba2-2.7b`` at its published widths cut to 32
     of 64 layers and ``zamba2-7b`` at its
     published widths cut to 15 layers, bf16 engines on phase 5's
     mixed-budget trace (ms per tick, tokens/s, prefill s, peak memory,
     launch counts), then an f32 2-layer ``serving_decode_step`` of each
     on the card against the CPU; then ``smollm-360m`` whole,
     ``mistral-nemo-12b`` (4 layers), ``qwen1.5-110b`` (2 layers) and
     ``qwen2-moe-a2.7b`` (4 layers) as bf16 paged engines on a short
     seeded trace, with the planner's MLP variant and the paged GQA
     kernel's launches. Phase 2 holds the GQA and GLU kernels at these
     configs' shapes;
 11. the vlm and audio frontends: ``musicgen-large`` whole (four
     codebook streams, multi-head attention, a gelu GLU) and
     ``pixtral-12b`` at its published widths cut to 8 layers (1024
     patch rows ahead of every prompt) as bf16 paged engines on the
     short trace (ms per tick, tokens/s, prefill s, peak memory, the
     planner's variant, launch counts), then an f32 2-layer decode step
     of each on the card against the CPU;
 12. training: ``Trainer.run`` on ``smollm-135m`` at full width (bf16, 8
     sequences of 512 tokens, 20 steps) three times -- the GLU's
     down-projection through the gated GEMM in FP, BP and WG
     (``mode="kernel"``: exactly 3 launches a layer a step), the relu
     MLP through the fused kernel (``mode="fused"``: one a layer a step)
     and dense -- each with ms per step, tokens/s, peak memory and its
     loss falling over the run; then one f32 2-layer step card against
     CPU (loss, every gradient, the optimizer's moments and update) and
     a checkpointed restart after an injected fault whose losses equal
     an uninterrupted run's. Phase 2 holds the GQA kernel at musicgen's
     heads, the GLU kernel's gelu at musicgen's widths, the gated GEMM
     at a training step's FP, BP and WG shapes and the fused relu MLP at
     its 4096 rows; after phases 11-12 those shapes' times are logged
     beside the library's and their bounds;
 13. serving on a (data, model) mesh, every rank a gloo process on card
     0, phase 4's 16 requests on its 8 slots at 8 new tokens each: the
     bf16 GLU engine on (1, 3), the bf16 relu engines on (2, 1),
     then f32 2-layer engines against the single rank;
 14. training on a (data, model) mesh, every rank a gloo process on card
     0: one f32 full-width step of smollm-135m on (1, 3) and on (2, 1)
     against a single-rank step (the reference's tolerances: loss rtol
     1e-4, grad norm 1e-3); phase 12's bf16 GLU kernel run on (1, 3)
     and relu fused run with ZeRO-1 on (2, 1), 2 steps each (every
     rank's losses equal, its launches exactly per layer x 30 x 2, its
     ms per step, collectives, peak memory and moment bytes);
     qwen2-moe-a2.7b at its published widths cut to 2 layers on (1, 2),
     30 experts a rank: one MoE layer's forward and gradient for 16
     tokens through the expert-parallel path against the single-rank
     global path (f32, nothing dropped), then 2 bf16 training steps
     (ms per step, each rank's expert bytes). Phase 2 holds the gated
     GEMM at the tp-3 shard's F 512 and the relu MLP at the dp-2 shard's
     2048 rows; after phase 14 their times are logged beside the
     library's and their bounds;
 15. pipeline parallelism and the dry run: ``smollm-135m``'s 30 layers
     at full width (bf16, the GLU's gated GEMM in FP, BP and WG) as a
     GPipe pipeline (``parallel/pipeline.py``) over a ("pod",) mesh of
     2 gloo ranks on card 0, 15 layers a stage, 8 x 512 tokens in 4
     micro-batches: a forward and a backward of sum(y**2) a step,
     ms per step beside one rank's sequential run, each rank's
     collectives and its launches exactly steps x schedule x 15 x 3;
     then the same pipeline at 4 layers in f32, its output and every
     gradient against one rank's sequential run; then the dry run's
     ``smollm-135m train_4k`` on (16, 16) and ``deepseek-v3-671b
     decode_32k`` on (2, 16, 16), traced on the meta device;
 16. sequence parallelism (``seq_shard``: the residual stream cut along
     the sequence over 'model' between blocks), every rank a gloo
     process on card 0: phase 14's bf16 GLU kernel run on (1, 3) with
     and without it (every rank's losses equal and falling, launches
     exactly 3 x 30 x 2, ms per step, peak memory, and its collectives:
     every row-parallel close a reduce-scatter, every column-parallel
     open an all-gather, counted exactly against plain TP's
     all-reduces); one f32 step with it at 4 layers (GLU kernel, relu
     fused) against one rank's, loss and every gradient within 1e-4 of
     their scale; ``zamba2-7b`` at its published widths (f32, 2 layers)
     decoding at batch 1 over caches whose rows are cut over 2 data
     ranks (the long-context layout) against the whole cache, each new
     row written by its owner alone; then the dry run's ``train_4k``
     with ``--seq-shard``, its temp below the cell's without it;
 17. the tensor-parallel Mamba2 mixer (each model rank runs its own
     heads), every rank a gloo process on card 0: ``mamba2-2.7b`` at its
     published widths cut to 4 layers, 2 bf16 training steps on (1, 2)
     with and without ``seq_shard`` beside one rank's (ms a step, each
     rank's collectives and peak memory), one f32 step each way whose
     loss, grad norm and every gradient equal one rank's at the mesh
     tests' tolerances; ``zamba2-7b`` at its published widths (2
     layers, ``attn_every`` 1) prefilling 4 x 256 tokens and decoding 4
     steps with ``h`` cut over the ranks' heads, in f32 (logits and
     ``h`` against one rank's) and in bf16 (the GLU kernel at a tp-2
     shard's F 7168), the conv windows equal bit for bit on both ranks;
     then the dry run's ``mamba2-2.7b train_4k`` on (2, 4), its temp and
     FLOPs a rank below the gathered mixer's.
 18. SASA's measuring autotuner (``sasa.autotune_mlp_plan``, 20 calls a
     candidate) at the relu decode tick in bf16 and f32, a 256-row
     prefill, a training step's 4096 rows (block sparsity 0.5 and 0) and
     a tp-3 shard's: each candidate's launches, a memoised second call,
     the winner the faster, both candidates' bits and y against the
     plain version, one line a shape of the byte model's variant against
     the measured winner (they may disagree); then the port's quickstart
     and GEMM demo examples on the card.

On every mesh of phases 14, 16 and 17 whose model size divides the
vocab (smollm-135m's on (1, 3), and every (1, 2) mesh's) the embedding,
head and loss run on each rank's vocab slice; every mesh run logs its
all-gather bytes a step and whether its vocab is cut.

Every phase prints its seconds. After phases 4-7, each of the nine kernels' time at its path's shapes
beside its plain version, a library yardstick and its bound.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero first.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
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
# Phase 12's training runs: smollm-135m at full width, 8 sequences of
# 512 tokens a step, from the synthetic corpus over the first ``vocab``
# token ids (over all 49152 a token recurs ~1.7 times in 20 steps, and
# the loss stays at ln 49152: nothing to learn that fast).
TRAIN = dict(batch=8, seq=512, steps=20, seed=0, vocab=4096)
# Phase 12's loss gate: the last 5 steps' mean within this of ln V, the
# loss of a model that knows which of the V ids occur (all equally often)
# and nothing of their order; the runs' init starts ~2.6 above it.
LOSS_OVER_LN_VOCAB = 0.25
TP3_F = 512  # smollm-135m's d_ff 1536 over 3 model ranks
# The launcher's --sparce tiling: per-slot rows, 128-wide f stripes.
SPARCE_BLOCKS = dict(block_m=1, block_k=128)


def arch_config():
    from repro_torch.configs import get_config
    return get_config(ARCH)


def relu_config():
    """The arch with the launcher's --sparce swap: a relu MLP (w_in,
    w_out; no w_gate)."""
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
# two-sided), the tall path's kernel (bf16, lhs gate, training rows), and
# the chunk reduction of a split-K call; every kernel a skipping plan of
# phase 7 runs.
GEMM_KERNELS = ("gated_gemm_kernel", "compacted_gemm_kernel",
                "gated_both_gemm_kernel", "tall_gemm_kernel",
                "chunk_reduce_kernel")
# The kernels of a gated-GLU call: the cluster kernel and the reduction
# over live stripes; of a fused relu MLP call, the same design's; of a
# paged MLA call, the chunk kernel and the merge of a slot's chunks; of a
# paged GQA call, the chunk kernel (which merges a slot's chunks in its
# last-arriving CTA); and the single kernel of each of the other calls
# (relu_bitmap and its backward: the instantiations of one kernel over
# the element operation, told apart by its name; the fused relu MLP's
# tall path at training rows).
GLU_KERNELS = ("glu_cluster_kernel", "stripe_reduce_kernel")
MLP_KERNELS = ("mlp_cluster_kernel", "mlp_tall_kernel",
               "stripe_reduce_kernel")
MLA_KERNELS = ("mla_chunk_kernel", "mla_combine_kernel")
GQA_KERNELS = ("gqa_chunk_kernel",)
RELU_KERNELS = ("ReluFwd",)
RELU_BWD_KERNELS = ("ReluBwd",)


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
            t = re.search(r"(tall_gemm_kernel)ILi(\d+)E|mlp_tall_kernel",
                          entry)
            if t is not None:
                what = (f"tall_gemm_kernel<bf16, 128 x {t.group(2)} tiles>"
                        if t.group(1) else "mlp_tall_kernel<bf16>")
                used = line.split("Used", 1)[1].strip()
                log(f"  {name}: {what}: {used}; {spill}")
                continue
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
                op = re.search(r"Relu(Fwd|Bwd)", entry)
                what += f", {op.group(0)}>" if op else ">"
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


# (KV heads, group, head_dim) of the GQA kernel's checks: smollm-135m's,
# then smollm-360m's, mistral-nemo-12b's (and pixtral-12b's), qwen1.5-
# 110b's (the kernel's limits, group 8 and head_dim 128), qwen2-moe-
# a2.7b's and musicgen-large's (multi-head: 32 KV heads of group 1);
# then a tensor-parallel shard's of smollm-135m at tp 3 (1 KV head).
ATTN_SHAPES = ((3, 3, 64), (5, 3, 64), (8, 4, 128), (8, 8, 128),
               (16, 1, 128), (32, 1, 64), (1, 3, 64))


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
    for (KV, g, D), (dtype, (atol, rtol, why)) in (
            (shape, tol) for shape in ATTN_SHAPES for tol in tols.items()):
        c = attn_case(torch, dev, dtype, seed=1, KV=KV, g=g, D=D)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
        got = pda.paged_gqa_decode_attn(*args)
        want = pda.paged_gqa_decode_attn_plain(*args)
        torch.cuda.synchronize()
        name = f"paged_gqa_decode_attn {str(dtype)[6:]} KV={KV} g={g} D={D}"
        err = check_close(name, got, want, atol=atol, rtol=rtol, why=why)
        if (KV, g, D) == ATTN_SHAPES[0]:
            errs[dtype] = err
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


def aliased_attn_case(torch, dev, dtype, seed, *, B=8, KV=3, g=3, D=64,
                      bs=16, max_blocks=32, n_shared=8):
    """Tables as the prefix cache lays them out: every live slot's first
    entries name the SAME ``n_shared`` physical blocks (a shared 128-row
    prefix), owned blocks after them; one slot dead, one shorter than
    the prefix. Also the same tables unaliased: each slot names its own
    copies of the shared blocks (equal bytes)."""
    rng = np.random.default_rng(seed)
    lengths = [0, 100, 128, 129, 160, 255, 400, 512]
    live = [-(-n // bs) for n in lengths]
    owned = [max(0, n - n_shared) for n in live]
    nb = 1 + n_shared + sum(owned) + B * n_shared
    ids = rng.permutation(np.arange(1, nb))
    shared, nxt = ids[:n_shared], n_shared
    tables = np.zeros((B, max_blocks), np.int32)
    copies = np.zeros((B, max_blocks), np.int32)
    for b in range(B):
        tables[b, :min(live[b], n_shared)] = shared[:live[b]]
        tables[b, n_shared:live[b]] = ids[nxt:nxt + owned[b]]
        nxt += owned[b]
    for b in range(B):
        copies[b] = tables[b]
        copies[b, :n_shared] = ids[nxt:nxt + n_shared]
        nxt += n_shared
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    k, v = mk(nb, bs, KV, D), mk(nb, bs, KV, D)
    for b in range(B):
        k[copies[b, :n_shared]] = k[shared]
        v[copies[b, :n_shared]] = v[shared]
    used = {int(t) for b in range(B) for t in tables[b, :live[b]]}
    return dict(q=mk(B, KV, g, D), k=k, v=v, nb=nb, live_ids=used,
                tables=torch.from_numpy(tables).to(dev),
                copies=torch.from_numpy(copies).to(dev),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev))


def check_attention_aliased(torch, dev):
    """The paged GQA kernel over tables in which several slots name the
    same blocks (the prefix cache's read-only sharing): equal to its
    plain version within the tolerance of ``check_attention``, equal bit
    for bit to the same call over unaliased copies (each slot's chunk
    walk and arrival counters are its own), and NaN-poisoned blocks no
    live prefix names never read."""
    from repro_torch.kernels import paged_decode_attn as pda
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        c = aliased_attn_case(torch, dev, dtype, seed=2)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
        got = pda.paged_gqa_decode_attn(*args)
        want = pda.paged_gqa_decode_attn_plain(*args)
        apart = pda.paged_gqa_decode_attn(c["q"], c["k"], c["v"],
                                          c["copies"], c["lengths"])
        torch.cuda.synchronize()
        name = f"paged_gqa_decode_attn {str(dtype)[6:]} aliased tables"
        check_close(name, got, want, atol=atol, rtol=atol,
                    why="as check_attention's")
        if not same_bits(torch, got, apart):
            raise AssertionError(f"{name}: differs from the same call over "
                                 "unaliased copies")
        dead = [i for i in range(c["nb"]) if i not in c["live_ids"]]
        kp, vp = c["k"].clone(), c["v"].clone()
        kp[dead] = float("nan")
        vp[dead] = float("nan")
        poisoned = pda.paged_gqa_decode_attn(c["q"], kp, vp, c["tables"],
                                             c["lengths"])
        torch.cuda.synchronize()
        if not torch.equal(poisoned, got):
            raise AssertionError(f"{name}: NaN-poisoned blocks reached the "
                                 "output")
        log(f"  {name}: 7 live slots share 8 blocks; equal bit for bit to "
            "unaliased copies, unnamed blocks never read -> ok")


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


# (K, F, N, row counts, act) of the GLU kernel's checks: smollm-135m's
# MLP at decode, a ragged and a full prefill bucket; smollm-360m's and
# zamba2-7b's shared block at decode and a 256-row prefill; musicgen-
# large's gelu GLU at decode and a 256-row prefill; smollm-135m's at a
# tensor-parallel shard's F (tp 3: 512 columns) at decode; zamba2-7b's
# shared block at a tp 2 shard's F (7168) at phase 17's 4 decode rows.
GLU_SHAPES = ((576, 1536, 576, (8, 100, 256), "silu"),
              (960, 2560, 960, (8, 256), "silu"),
              (3584, 14336, 3584, (8, 256), "silu"),
              (2048, 8192, 2048, (8, 256), "gelu"),
              (576, 512, 576, (8,), "silu"),
              (3584, 7168, 3584, (4,), "silu"))


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
        for K, F, N, M, act, tau in (
                (K, F, N, M, act, tau)
                for K, F, N, Ms, act in GLU_SHAPES for M in Ms
                for tau in (0.0, 0.05)):
            x, wg, wi, wo = glu_case(torch, dev, dtype, seed=2, M=M,
                                     K=K, F=F, N=N)
            kw = dict(block_m=bm, block_f=bf, act=act, tau=tau)
            y, bits = sgm.sparce_glu_mlp_fused(x, wg, wi, wo, **kw)
            y0, bits0 = sgm.sparce_glu_mlp_fused_plain(x, wg, wi, wo, **kw)
            torch.cuda.synchronize()
            name = (f"sparce_glu_mlp_fused {str(dtype)[6:]} {act} M={M} "
                    f"K={K} F={F} tau={tau}")
            if not torch.equal(bits, bits0):
                raise AssertionError(f"{name}: bits differ")
            y1, bits1 = sgm.sparce_glu_mlp_fused(x, wg, wi, wo, **kw)
            if not (same_bits(torch, y1, y)
                    and torch.equal(bits1, bits)):
                raise AssertionError(f"{name}: a second call differs")
            dead = int(bits.sum())
            if dead == 0:
                raise AssertionError(f"{name}: expected dead stripes")
            err = check_close(f"{name} ({dead} dead tiles)", y, y0,
                              atol=atol, rtol=rtol, why=why)
            if (dtype == torch.bfloat16 and M == 8 and tau == 0.0
                    and (K, F) == GLU_SHAPES[0][:2]):
                err_main = err
            # NaN poison the dead stripes' w_in columns and w_out rows
            # of every row tile that has them dead in ALL row tiles.
            dead_f = bits.bool().all(dim=0).nonzero().flatten().tolist()
            wi2, wo2 = wi.clone(), wo.clone()
            for f in dead_f:
                wi2[:, f * bf:(f + 1) * bf] = float("nan")
                wo2[f * bf:(f + 1) * bf] = float("nan")
            y2, bits2 = sgm.sparce_glu_mlp_fused(x, wg, wi2, wo2, **kw)
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
# prefill bucket at the launcher's per-slot tiles, and 64-row tiles; a
# data shard's 4 slots (dp 2).
RELU_CASES = ((8, 1), (256, 1), (256, 64), (4, 1))
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


def train_gemm_operands(torch, dtype, seed, F_=1536,
                        M=TRAIN["batch"] * TRAIN["seq"]):
    """A smollm-135m training step's down-projection at full width (``M``
    rows: 8 x 512 tokens, or a pipeline micro-batch's 2 x 512; d_model
    576; d_ff ``F_``: 1536, or a tp-3 shard's 512): activations a and an
    error g, unit normals with 30% of their (64, 128) tiles zero, and
    w_out at init scale; on the host. (A mean loss's error is M^-1/2
    smaller; the checks' limits are shares of the output's scale, so the
    scale of g does not move them.)"""
    rng = np.random.default_rng(seed)
    N = 576
    bm, bk, bn = 64, 128, 128

    def tiled_zeros(a, br, bc):
        gr, gc = -(-a.shape[0] // br), -(-a.shape[1] // bc)
        for i, j in zip(*np.nonzero(rng.random((gr, gc)) < 0.3)):
            a[i * br:(i + 1) * br, j * bc:(j + 1) * bc] = 0.0
        return a
    a = tiled_zeros(rng.standard_normal((M, F_), dtype=np.float32), bm, bk)
    w = rng.standard_normal((F_, N), dtype=np.float32) / np.sqrt(F_)
    g = tiled_zeros(rng.standard_normal((M, N), dtype=np.float32), bm, bn)
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    return t(a), t(w), t(g), (bm, bk, bn)


# Limits of the training GEMMs: max|got - want| as a share of max|want|.
# An absolute limit is loose on a small output (BP's) and tight on a
# large one (WG's sums over 4096 rows). f32: 10x the largest share read
# on the card; bf16: above one rounding of the largest output to bf16
# (at most 2^-7 of it) after f32 sums.
TRAIN_GEMM_REL = {
    "float32": (1e-5, "f32 (split-TF32) sums over K in another order"),
    "bfloat16": (1e-2, "one bf16 rounding of each output after f32 sums "
                 "in another order"),
}


# max_abs_err of each tall path at its training shape (phase 2), for the
# kernels line: the gated GEMM at row 5b's BP, the relu MLP at row 3b.
TALL_ERRS = {}
# The tall GEMM's ragged check: M, K and N past whole tiles (TMA's zero
# fill and y's masked store), (64, 128) tiles.
TALL_RAGGED_GEMM = (1100, 600, 1000, 64, 128)


def check_tall_gemm(torch, dev, x, w, bits, kw, got, name):
    """What the tall path adds to a gated call's checks: it ran (one tall
    launch), a second call equal bit for bit, and the compacted kernel,
    taking the same tall path, equal bit for bit."""
    from repro_torch.kernels import sparce_gemm as sg
    n0 = (sg.sparce_gemm_gated.tall_launches,
          sg.sparce_gemm_compacted.tall_launches)
    again = sg.sparce_gemm_gated(x, w, bits, **kw)
    comp = sg.sparce_gemm_compacted(x, w, bits, **kw)
    torch.cuda.synchronize()
    if (sg.sparce_gemm_gated.tall_launches - n0[0],
            sg.sparce_gemm_compacted.tall_launches - n0[1]) != (1, 1):
        raise AssertionError(f"{name}: the tall path did not run")
    if not (same_bits(torch, again, got) and same_bits(torch, comp, got)):
        raise AssertionError(f"{name}: a second call or the compacted "
                             "kernel differs bit for bit")


def check_train_gemm(torch, dev):
    """The gated GEMM at the three GEMMs of a training step's
    down-projection under ``mode="kernel"``, through ``ops.sparce_gemm``
    as ``sparse_ops``' autograd rule calls it (transposed views, copied
    to contiguous memory there): FP ``a @ w_out`` gated on a's (64, 128)
    tiles; BP ``g @ w_out^T`` gated on g's (64, 128) error tiles
    (block_k = block_n); WG ``a^T @ g`` gated on the transposed feature
    bits, tiles (128, 64). At the whole batch's rows with d_ff 1536 and
    a tp-3 shard's F, at a pipeline micro-batch's rows (phase 15; WG
    reduces over them), and at phase 16's 8 x SP_SEQ rows with the tp-3
    shard's F. Each on the card against the same call on
    the CPU (the plain version), within ``TRAIN_GEMM_REL`` of the
    output's largest value, then with the gated tiles NaN-poisoned on
    the card."""
    from repro_torch.core import sasa, sprf
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_gemm as sg
    M = TRAIN["batch"] * TRAIN["seq"]
    shapes = ((1536, M), (TP3_F, M), (1536, PIPE_MICRO_ROWS),
              (TP3_F, TRAIN["batch"] * SP_SEQ))
    for dtype, (F_, M_) in itertools.product(
            (torch.float32, torch.bfloat16), shapes):
        rel, why = TRAIN_GEMM_REL[str(dtype)[6:]]
        a, w, g, (bm, bk, bn) = train_gemm_operands(torch, dtype, seed=8,
                                                    F_=F_, M=M_)
        abits = sprf.compute_bitmap(a, (bm, bk)).bits
        gbits = sprf.compute_bitmap(g, (bm, bn)).bits
        cases = (("FP", a, w, abits, (bm, bk, bn)),
                 ("BP", g, w.T, gbits, (bm, bn, bk)),
                 ("WG", a.T, g, abits.T.contiguous(), (bk, bm, bn)))
        for label, x, y_rhs, bits, (pm, pk, pn) in cases:
            plan = sasa.SkipPlan(gate="lhs", variant="gated", block_m=pm,
                                 block_k=pk, block_n=pn)
            name = (f"sparce_gemm_gated {str(dtype)[6:]} training {label} "
                    f"{tuple(x.shape)} @ {tuple(y_rhs.shape)} tiles "
                    f"({pm}, {pk}) x {pn}")

            def run(x, y_rhs, bits, where):
                bmp = sprf.TileBitmap(bits.to(where), (pm, pk),
                                      tuple(x.shape))
                return kops.sparce_gemm(x.to(where), y_rhs.to(where), plan,
                                        lhs_bitmap=bmp)
            tall = sg.tall_path(*x.shape, y_rhs.shape[1], block_m=pm,
                                block_k=pk, dtype=dtype)
            if tall != (dtype == torch.bfloat16):
                raise AssertionError(f"{name}: tall path {tall}")
            n0 = sg.sparce_gemm_gated.tall_launches
            got = run(x, y_rhs, bits, dev)
            moved = sg.sparce_gemm_gated.tall_launches - n0
            want = run(x, y_rhs, bits, torch.device("cpu"))
            torch.cuda.synchronize()
            if moved != int(tall):
                raise AssertionError(f"{name}: {moved} tall launches")
            scale = want.float().abs().max().item()
            err = check_close(f"{name} ({int(bits.sum())} of "
                              f"{bits.numel()} tiles gated; "
                              f"{'tall path, plan ' + str(sg.tall_plan(*x.shape, y_rhs.shape[1], block_m=pm, block_k=pk, dtype=dtype)) if tall else 'core'})",
                              got.cpu(), want,
                              atol=rel * scale, rtol=0.0,
                              why=f"{rel} of max|want| {scale:.4e}: {why}")
            log(f"    max_abs_err / max|want| = {err / scale:.3e} "
                f"(limit {rel})")
            if tall:
                check_tall_gemm(torch, dev, x.to(dev).contiguous(),
                                y_rhs.to(dev).contiguous(), bits.to(dev),
                                dict(block_m=pm, block_k=pk, block_n=pn),
                                got, name)
                if (label, F_, M_) == ("BP", 1536, M):
                    TALL_ERRS["sparce_gemm_gated"] = err
            x2 = x.to(dev).contiguous().clone()
            for i, j in zip(*np.nonzero(bits.numpy())):
                x2[i * pm:(i + 1) * pm, j * pk:(j + 1) * pk] = float("nan")
            got2 = run(x2, y_rhs, bits, dev)
            torch.cuda.synchronize()
            if not (torch.isfinite(got2).all() and torch.equal(got2, got)):
                raise AssertionError(f"{name}: NaN-poisoned gated tiles "
                                     "reached the output")
    # The tall path at a ragged shape: rows, depth and columns past whole
    # tiles and stages.
    M_, K_, N_, pm, pk = TALL_RAGGED_GEMM
    rng = np.random.default_rng(21)
    x = rng.standard_normal((M_, K_), dtype=np.float32)
    bits = (rng.random((-(-M_ // pm), -(-K_ // pk))) < 0.3).astype(np.int32)
    w = rng.standard_normal((K_, N_), dtype=np.float32) / np.sqrt(K_)
    x, w = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (x, w))
    bits = torch.from_numpy(bits).to(dev)
    kw = dict(block_m=pm, block_k=pk, block_n=128)
    name = (f"sparce_gemm_gated bf16 tall ragged {M_}x{K_} @ {K_}x{N_} "
            f"tiles ({pm}, {pk})")
    got = sg.sparce_gemm_gated(x, w, bits, **kw)
    want = sg.sparce_gemm_gated_plain(x, w, bits, **kw)
    torch.cuda.synchronize()
    rel, why = TRAIN_GEMM_REL["bfloat16"]
    scale = want.float().abs().max().item()
    check_close(name, got, want, atol=rel * scale, rtol=0.0,
                why=f"{rel} of max|want| {scale:.4e}: {why}")
    check_tall_gemm(torch, dev, x, w, bits, kw, got, name)
    x2 = x.clone()
    for i, j in zip(*np.nonzero(bits.cpu().numpy())):
        x2[i * pm:(i + 1) * pm, j * pk:(j + 1) * pk] = float("nan")
    if not same_bits(torch, sg.sparce_gemm_gated(x2, w, bits, **kw), got):
        raise AssertionError(f"{name}: NaN-poisoned gated tiles reached y")
    log("  sparce_gemm_gated at the training step's FP, BP and WG shapes "
        f"(d_ff 1536, a tp-3 shard's {TP3_F}, a pipeline micro-batch's "
        f"{PIPE_MICRO_ROWS} rows, and phase 16's {TRAIN['batch'] * SP_SEQ} "
        f"rows at F {TP3_F}; bf16 on the tall path, f32 on the core; and "
        f"the tall path at {M_}x{K_} @ {K_}x{N_}): NaN-poisoned gated "
        "tiles never read, tall second calls and the compacted kernel "
        "equal bit for bit -> ok")


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
    # (M, F, block_m): the relu cases at F 1536, then ragged M and F, then
    # a training step's forward (8 x 512 tokens, the default 64-row tiles),
    # a dp-2 shard's (2048 rows) and phase 16's tp-3 shard (8 x SP_SEQ
    # rows, F 512).
    # rows, F 1536, and phase 16's tp-3 shard (8 x SP_SEQ rows, F 512);
    # those four take the tall path in bf16, as does a ragged one (M, K,
    # F and N past whole tiles).
    cases = [(M, 1536, bm) for M, bm in RELU_CASES] + [
        (37, 1000, 1), (37, 1000, 64), (100, 1000, 64)] + [
        (TRAIN["batch"] * TRAIN["seq"], 1536, 64),
        (TRAIN["batch"] * TRAIN["seq"] // 2, 1536, 64),
        (TRAIN["batch"] * SP_SEQ, TP3_F, 64), (1100, 1000, 64, 568, 600)]
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol, why = RELU_TOLS[str(dtype)[6:]]
        for M, F_, bm, *kn in cases:
            K_, N_ = kn or (576, 576)
            for act in ("relu", "relu2"):
                x, wi, wo = mlp_case(torch, dev, dtype, seed=M + bm, M=M,
                                     bm=bm, F=F_, K=K_, N=N_)
                kw = dict(block_m=bm, block_f=bf, act=act)
                tall = sm.tall_path(M, K_, F_, N_, block_m=bm, block_f=bf,
                                    dtype=dtype)
                n0 = sm.sparce_mlp_fused.tall_launches
                y, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
                moved = sm.sparce_mlp_fused.tall_launches - n0
                y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **kw)
                torch.cuda.synchronize()
                name = (f"sparce_mlp_fused {str(dtype)[6:]} {act} M={M} "
                        f"K={K_} F={F_} N={N_} block_m={bm}"
                        + (" (tall path)" if tall else ""))
                if moved != int(tall):
                    raise AssertionError(f"{name}: tall launches differ")
                if tall != (dtype == torch.bfloat16 and M >= 1024):
                    raise AssertionError(f"{name}: tall path {tall}")
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
                if tall and M == TRAIN["batch"] * TRAIN["seq"] and \
                        act == "relu":
                    TALL_ERRS["sparce_mlp_fused"] = err
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


def relu_bwd_operands(shape, block, seed):
    """x and g (f32 numpy) for a relu backward: tile (0, 0) has x <= 0
    under a NaN g (dropped: dead), a second tile (the next one of row
    tile 0, else of column tile 0) has g = -0.0 (dead), and the last
    tile's only nonzero gx is a NaN (live). Returns (x, g, second)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    (br, bc), (r, c) = block, shape
    x[:br, :bc], g[:br, :bc] = -1.0, np.nan
    second = (0, 1) if c > bc else (1, 0)
    g[second[0] * br:(second[0] + 1) * br,
      second[1] * bc:(second[1] + 1) * bc] = -0.0
    lr, lc = (r - 1) // br * br, (c - 1) // bc * bc
    x[lr:, lc:], g[lr:, lc:] = 1.0, 0.0
    g[-1, -1] = np.nan
    return x, g, second


def check_relu_bwd(torch, dev):
    """gx and bits equal the plain version's exactly, at the relu decode
    tick's shape, a prefill, a tall tile and ragged shapes the kernel
    takes unpadded (phase 7's conv1 output among them): NaN in g where
    x <= 0 never reaches gx, a NaN where x > 0 passes (bit 0), -0.0
    counts as zero. Returns the largest |gx - plain| over the non-NaN
    positions of every case."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import relu_bitmap as rb
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, (br, bc) in (((8, 1536), (1, 128)),
                                ((256, 1536), (1, 128)),
                                ((128, 256), (64, 128)),
                                ((7, 300), (1, 128)), ((10, 300), (8, 128)),
                                ((3025, 96), (8, 128)),
                                ((3025, 96), (256, 128))):
            x, g, second = relu_bwd_operands(shape, (br, bc),
                                             seed=shape[0] + br)
            xt, gt = (torch.from_numpy(a).to(dev, dtype) for a in (x, g))
            gx, bits = rb.relu_bwd_bitmap(xt, gt, block_r=br, block_c=bc)
            gx0, bits0 = rb.relu_bwd_bitmap_plain(xt, gt, block_r=br,
                                                  block_c=bc)
            torch.cuda.synchronize()
            name = (f"relu_bwd_bitmap {str(dtype)[6:]} {shape} tile "
                    f"({br},{bc})")
            if not (torch.equal(bits, bits0) and same_bits(torch, gx, gx0)):
                raise AssertionError(f"{name}: gx or bits differ")
            if not (bits[0, 0] == 1 and bits[second] == 1
                    and bits[-1, -1] == 0
                    and int(torch.isnan(gx).sum()) == 1):
                raise AssertionError(f"{name}: NaN or -0.0 mishandled")
            ok = ~torch.isnan(gx0)
            err = max(err, float((gx[ok].float() - gx0[ok].float()).abs()
                                 .max()))
            log(f"  {name}: gx and bits equal the plain version's bit for "
                f"bit ({int(bits.sum())} dead tiles) -> ok")
        xt = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (10, 300), dtype=np.float32)).to(dev, dtype)
        gx, bmp = kops.relu_bwd_with_bitmap(xt, xt, (8, 128))
        gx0, bmp0 = kops.relu_bwd_with_bitmap(xt.cpu(), xt.cpu(), (8, 128))
        if not (torch.equal(gx.cpu(), gx0) and gx.is_contiguous()
                and torch.equal(bmp.bits.cpu(), bmp0.bits)):
            raise AssertionError("ops.relu_bwd_with_bitmap differs from the "
                                 "CPU")
    return err


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
    toks = rng.integers(0, cfg.vocab_size, (B,) + codebooks(cfg) + (1,))
    return caches, tables, active, toks


def to_device(tree, dev):
    import torch
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(v, dev) for v in tree))
    # A copy even on the same device: a step updates its caches in place.
    return (tree.to(dev, copy=True) if isinstance(tree, torch.Tensor)
            else tree)


def check_decode_step(torch, dev, base_cfg, sparsity, label):
    """One f32 full-width decode step of ``base_cfg`` under ``sparsity``:
    kernels on the card against plain versions on the CPU."""
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
    clear = (top2[..., 0] - top2[..., 1]) > 2 * atol
    same = lg[live].argmax(-1) == lc[live].argmax(-1)
    if not bool(same[clear].all()):
        raise AssertionError("argmax differs where the top-2 gap is clear")
    log(f"  {label}: argmax equal on {int(clear.sum())}/{clear.numel()} "
        f"live rows with a clear top-2 gap; skip stats {sk.tolist()} "
        "equal -> ok")


# ------------------------------------------------------------ the engine
def codebooks(cfg):
    """The leading token dims of the audio frontend's (K, S) streams."""
    return (cfg.num_codebooks,) if cfg.frontend == "codes" else ()


def engine_requests(cfg, n, seed, *, mixed=False, trace=ENGINE):
    """The seeded trace: prompts of ``trace``'s lengths, its
    ``max_new`` tokens each; with ``mixed`` each budget is drawn from
    [max_new // 4, max_new] (the launcher's --mixed rule), so slots free
    at different ticks and the tail runs with dead slots."""
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(seed)
    budgets = [trace["max_new"]] * n
    if mixed:
        budgets = np.random.default_rng(seed + 1).integers(
            trace["max_new"] // 4, trace["max_new"] + 1, n).tolist()
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, codebooks(cfg) + (int(rng.integers(
            trace["prompt_lo"], trace["prompt_hi"] + 1)),)),
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
               mixed=False, trace=ENGINE, kv_block_size=None,
               profile=True):
    """Serve the seeded trace once on the full-width bf16 engine; every
    kernel in ``expect`` must have launched during the run. The layout
    is ``trace``'s paged pool (with the paged attention kernel) unless
    ``kv_block_size`` is 0: then the contiguous one, with the gather
    path (the ssm and hybrid families are contiguous whatever the block
    size). Returns (metrics, {kernel: launches in the run})."""
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.server import ServeConfig, Server
    bs = trace["block_size"] if kv_block_size is None else kv_block_size
    paged = bs > 0 and cfg.family in model_lib.paged_families()
    sc = ServeConfig(
        batch_slots=trace["slots"], max_len=trace["max_len"],
        kv_block_size=bs, attn_kernel="paged" if paged else "gather",
        sparsity=sparsity)
    # Warm-up run (library loads, allocator, cuBLAS handles).
    Server(cfg, params, sc, device=dev).generate(
        engine_requests(cfg, 2, seed=99, trace=trace))
    srv = Server(cfg, params, sc, device=dev)
    reqs = engine_requests(cfg, trace["requests"], seed=trace["seed"],
                           mixed=mixed, trace=trace)
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
    if paged and not m.attn_block_skip_fraction > 0:
        raise AssertionError("no attention block was skipped")
    if not 0 <= m.skipped_tile_dots <= m.total_tile_dots:
        raise AssertionError("inconsistent skip counters")
    if paged and (srv._st.alloc.in_use or srv._st.alloc.reserved):
        raise AssertionError("KV pool did not drain")
    if m.kv_paged != float(paged):
        raise AssertionError(f"kv_paged={m.kv_paged}, expected {paged}")
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
    if profile:
        profile_engine(torch, cfg, params, sc, dev, label, trace=trace)
    return m, launches


@contextlib.contextmanager
def drawn_on_card(torch):
    """``modules.normal_init`` draws on the leaf's device while the block
    runs: each leaf still takes its seed from the init's numpy generator,
    and its values are ``torch.randn`` on a generator seeded with it,
    scaled, then cast. The numbers differ from the host init's; a
    full-width init then spends no host time (DeepSeek-V3's 4 layers
    are 15.1 G normals). The draws depend only on the seeds, so ranks
    drawing on one card draw the same values."""
    from repro_torch.models import modules
    host = modules.normal_init

    def normal_init(rng, shape, scale, dtype, device):
        seed = int(rng.integers(1 << 63))
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        flat = out.view(-1)
        g = torch.Generator(device=out.device).manual_seed(seed)
        for s0 in range(0, flat.numel(), CARD_DRAW_VALUES):
            m = min(CARD_DRAW_VALUES, flat.numel() - s0)
            flat[s0:s0 + m] = torch.randn(
                m, generator=g, device=out.device).mul_(scale)
        return out

    modules.normal_init = normal_init
    try:
        yield
    finally:
        modules.normal_init = host


# f32 normals a ``drawn_on_card`` draw stages on the card (1 GiB).
CARD_DRAW_VALUES = 1 << 28


def full_width_params(torch, cfg, dev):
    """Seeded full-width weights of ``cfg``, drawn on the card."""
    from repro_torch.models import model as model_lib
    t0 = time.perf_counter()
    with drawn_on_card(torch):
        params = model_lib.init_params(cfg, seed=ENGINE["seed"], device=dev)
    torch.cuda.synchronize()
    log(f"  full-width bf16 {cfg.mlp_act} params "
        f"({sum(p.numel() for p in _leaves(params))} values) in "
        f"{time.perf_counter() - t0:.2f}s")
    return params


def glu_sparsity():
    """Phase 4's sparsity: the gated GLU through the fused GLU kernel,
    exact dead-tile test."""
    from repro_torch.core.sparse_ops import SparsityConfig
    return SparsityConfig(enabled=True, mode="fused", gate_threshold=0.0,
                          autotune=False)


def run_glu_engine(torch, dev):
    """Phase 4; returns (metrics, launches)."""
    cfg = arch_config()
    params = full_width_params(torch, cfg, dev)
    return run_engine(
        torch, dev, cfg, params, glu_sparsity(), "glu fused",
        ("paged_gqa_decode_attn", "sparce_glu_mlp_fused"))


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


# Phase 8's trace: a seeded shared prefix of 8 blocks (--shared-prefix-len
# 128) before every prompt, tails of 16-128 tokens, budgets from [8, 32].
PREFIX = dict(requests=16, prefix_len=128, tail_lo=16, tail_hi=128,
              seed=3)


def prefix_requests(cfg, seed):
    """Phase 8's requests: PREFIX["requests"] prompts of the shared prefix
    and a seeded tail, the first tail a whole number of blocks; then a
    byte-identical re-prompt of the first request (a full-prompt match,
    the copy-on-write case)."""
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(seed)
    bs = ENGINE["block_size"]
    prefix = rng.integers(0, cfg.vocab_size, PREFIX["prefix_len"])
    reqs = []
    for i in range(PREFIX["requests"]):
        n = int(rng.integers(PREFIX["tail_lo"], PREFIX["tail_hi"] + 1))
        if i == 0:
            n -= n % bs
        reqs.append(Request(uid=i, prompt=np.concatenate(
            [prefix, rng.integers(0, cfg.vocab_size, n)]),
            max_new=int(rng.integers(ENGINE["max_new"] // 4,
                                     ENGINE["max_new"] + 1))))
    reqs.append(Request(uid=len(reqs), prompt=reqs[0].prompt.copy(),
                        max_new=reqs[0].max_new))
    return reqs


def prefix_counts(reqs, bs):
    """The prefix-cache counters the trace must produce, counted on the
    host from the prompts in admission (queue) order with nothing
    evicted: a lookup per request, the longest run of already registered
    chain keys, a fork when the run covers the whole prompt (its last
    row re-runs), then the prompt's full blocks registered."""
    from repro_torch.runtime.paging import PrefixCache
    index = set()
    c = dict(prefix_lookups=0, prefix_hits=0, prefix_matched_tokens=0,
             prefix_blocks_shared=0, prefix_cow_forks=0)
    for r in reqs:
        keys = PrefixCache.chain_keys(r.prompt, bs)
        n = 0
        while n < len(keys) and keys[n] in index:
            n += 1
        rows0 = len(r.prompt)
        cow = n > 0 and n * bs == rows0
        c["prefix_lookups"] += 1
        c["prefix_hits"] += n > 0
        c["prefix_matched_tokens"] += (rows0 - 1 if cow else n * bs)
        c["prefix_blocks_shared"] += n - 1 if cow else n
        c["prefix_cow_forks"] += cow
        index.update(keys[:rows0 // bs])
    return c


def serve_prefix_trace(torch, dev, cfg, params, sp, reqs, prefix_cache):
    """One drain-mode run of ``reqs`` with the cache off or on; the launch
    counts are read around it. Returns (server, done, launches, wall)."""
    from repro_torch.runtime.server import ServeConfig, Server
    sc = ServeConfig(batch_slots=ENGINE["slots"], max_len=ENGINE["max_len"],
                     kv_block_size=ENGINE["block_size"], attn_kernel="paged",
                     sparsity=sp, prefix_cache=prefix_cache)
    srv = Server(cfg, params, sc, device=dev)
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = srv.generate([dataclasses.replace(r, out=None, stats={})
                         for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return srv, done, {n: f.launches for n, f in wrappers.items()}, wall


def run_prefix_engine(torch, dev):
    """Phase 8: the full-width bf16 GLU engine (``mode="fused"``, the
    paged decode kernel) on a shared-prefix trace with the prefix cache
    off, then on; then an f32 2-layer engine at full width on a hit and a
    copy-on-write request, cache off against on."""
    from repro_torch.core.sparse_ops import SparsityConfig
    cfg = arch_config()
    params = full_width_params(torch, cfg, dev)
    sp = SparsityConfig(enabled=True, mode="fused", gate_threshold=0.0,
                        autotune=False)
    bs = ENGINE["block_size"]
    reqs = prefix_requests(cfg, PREFIX["seed"])
    # Warm-up (library loads, the suffix prefill's shapes).
    serve_prefix_trace(torch, dev, cfg, params, sp, reqs[:3], True)
    runs = {on: serve_prefix_trace(torch, dev, cfg, params, sp, reqs, on)
            for on in (False, True)}
    m = {on: runs[on][0].metrics for on in runs}
    for on, (srv, done, launches, wall) in runs.items():
        label = "cache on " if on else "cache off"
        if len(done) != len(reqs) or any(len(r.out) != r.max_new
                                          for r in done):
            raise AssertionError(f"{label}: not every request completed")
        log(f"  {label}: {len(done)} requests, {int(m[on].decode_tokens)} "
            f"decode tokens in {int(m[on].ticks)} ticks, "
            f"{1e3 * m[on].decode_s / m[on].ticks:.3f} ms per decode tick; "
            f"prefill {int(m[on].prefill_tokens)} tokens in "
            f"{m[on].prefill_s:.3f}s; wall {wall:.3f}s")
    for name in ("ticks", "decode_tokens", "attn_blocks_fetched",
                 "attn_blocks_total"):
        if getattr(m[True], name) != getattr(m[False], name):
            raise AssertionError(f"{name}: cache on {getattr(m[True], name)}"
                                 f" != off {getattr(m[False], name)}")
    for total, pre in (("skipped_tile_dots", "prefill_skipped_tile_dots"),
                       ("total_tile_dots", "prefill_total_tile_dots")):
        on, off = (getattr(m[x], total) - getattr(m[x], pre)
                   for x in (True, False))
        if on != off:
            raise AssertionError(f"decode {total}: cache on {on} != off "
                                 f"{off}")
    want = prefix_counts(reqs, bs)
    got = {k: getattr(m[True], k) for k in want}
    if got != want or m[True].prefix_evicted_blocks:
        raise AssertionError(f"prefix counters {got} (evicted "
                             f"{m[True].prefix_evicted_blocks}), counted on "
                             f"the host {want}")
    if not m[True].prefill_tokens < m[False].prefill_tokens:
        raise AssertionError("the cache saved no prefill token")
    srv = runs[True][0]
    alloc = srv._st.alloc
    if alloc.in_use != len(srv._prefix) or alloc.reserved:
        raise AssertionError(f"after the run {alloc.in_use} blocks in use, "
                             f"{len(srv._prefix)} indexed, "
                             f"{alloc.reserved} reserved")
    alloc.check(expect_reserved=0)
    if list(srv.admitted_uids) != [r.uid for r in reqs]:
        raise AssertionError("admission left the queue order")
    launches = runs[True][2]
    for name in ("paged_gqa_decode_attn", "sparce_glu_mlp_fused"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched with the cache on")
    outs = {on: {r.uid: r.out.tolist() for r in runs[on][1]} for on in runs}
    same = sum(outs[True][u] == outs[False][u] for u in outs[False])
    log(f"  prefix counters equal the host's count {want}; ticks, decode "
        f"tokens, decode skip and attention block counters equal off and "
        f"on; only the index holds blocks ({alloc.in_use}) -> ok")
    log(f"  bf16 token streams equal between cache off and on: "
        f"{same}/{len(reqs)} (the prefix rows of a hit were written by "
        "another request's prefill at another bucket: a near-tie may flip)")
    log(f"  launches with the cache on: "
        f"{ {k: v for k, v in launches.items() if v} }")
    check_prefix_f32(torch, dev, cfg, params, reqs)
    return launches


def check_prefix_f32(torch, dev, cfg, params, reqs):
    """Full width, 2 layers, f32 (TF32 off): a miss, a hit on its shared
    prefix and the copy-on-write re-prompt, served with the cache off and
    on: greedy streams of 8 tokens equal, and each first token's logits
    (from the full prefill, the suffix prefill) allclose."""
    from repro_torch.core.sparse_ops import SparsityConfig
    from repro_torch.runtime.server import ServeConfig, Server
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    p32 = {k: v for k, v in params.items() if k != "stack"}
    p32["stack"] = params["stack"][:2]
    p32 = to_device(p32, dev)
    upcast_in_place(torch, p32)
    trio = [dataclasses.replace(r, max_new=8)
            for r in (reqs[0], reqs[1], reqs[-1])]
    sp = SparsityConfig(enabled=True, mode="fused", gate_threshold=0.0,
                        autotune=False)
    outs, firsts = {}, {}
    for on in (False, True):
        srv = Server(cfg32, p32, ServeConfig(
            batch_slots=ENGINE["slots"], max_len=ENGINE["max_len"],
            kv_block_size=ENGINE["block_size"], attn_kernel="paged",
            sparsity=sp, prefix_cache=on), device=dev)
        seen = {}

        def keep(fn):
            def wrapped(r, *a):
                last, caches = fn(r, *a)
                seen[r.uid] = last
                return last, caches
            return wrapped

        srv._prefill_one = keep(srv._prefill_one)
        srv._prefill_suffix = keep(srv._prefill_suffix)
        done = srv.generate([dataclasses.replace(r, out=None, stats={})
                             for r in trio])
        outs[on] = {r.uid: r.out.tolist() for r in done}
        firsts[on] = seen
        if on:
            m = srv.metrics
            if (m.prefix_hits, m.prefix_cow_forks) != (2, 1):
                raise AssertionError(f"f32 run: {int(m.prefix_hits)} hits, "
                                     f"{int(m.prefix_cow_forks)} forks")
    if outs[True] != outs[False]:
        raise AssertionError(f"f32 greedy streams differ: {outs}")
    for uid in outs[True]:
        check_close(f"f32 2-layer first-token logits uid={uid} cache on vs "
                    "off", torch.from_numpy(firsts[True][uid]),
                    torch.from_numpy(firsts[False][uid]), atol=1e-4,
                    rtol=1e-4, why="the suffix prefill's attention sums "
                    "over the scratch in another chunking")
    log(f"  f32 2-layer full width: greedy streams of 8 tokens equal with "
        f"the cache off and on (a miss, a hit, a copy-on-write re-prompt)"
        " -> ok")


# ------------------------------------------------ phase 9: the live engine
# Phase 9's open-loop trace (virtual ticks): Poisson arrivals at 0.25 a
# tick, a burst of 20 more at tick 40, prompts of 16-256 tokens (every
# other one behind one seeded 128-token prefix, as the launcher's
# --shared-prefix-len prepends it), budgets from [8, 32], a quarter at
# priority 1.0 with a TTFT deadline of 2 ticks, 4 requests with a
# max_ticks deadline. (A burst of 12 into an empty queue never reaches
# the 16-deep bound, so nothing would shed; without deadlines no head is
# TTFT-forced within 48 ticks, so nothing would be preempted.)
LIVE = dict(requests=32, rate=0.25, burst_at=40.0, burst_n=20,
            prompt_lo=16, prompt_hi=256, prefix_len=128, new_lo=8,
            new_hi=32, max_ticks=4, max_ticks_uids=(5, 14, 27, 38),
            priority_deadline=2.0, seed=0)
# Every ServeMetrics field but the wall-clock ones is a function of the
# schedule and the skip pattern.
WALL_FIELDS = ("prefill_s", "decode_s", "ttft_s_p50", "ttft_s_p99")
WAIT_S = 300  # a bound on every blocking call of phase 9


def live_config(sparsity):
    """Phase 9's engine: 8 slots over a 96-block pool (the worst case is
    256), the prefix cache, preemption, a 16-deep queue, a TTFT / ITL
    SLO of 48 / 3 ticks and a seeded fault plan."""
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.scheduler import SLOConfig
    from repro_torch.runtime.server import ServeConfig
    return ServeConfig(
        batch_slots=ENGINE["slots"], max_len=ENGINE["max_len"],
        kv_block_size=ENGINE["block_size"], kv_pool_blocks=96,
        attn_kernel="paged", sparsity=sparsity, prefix_cache=True,
        preempt=True, max_queue_depth=16,
        slo=SLOConfig(target_ttft_ticks=48, target_itl_ticks=3),
        faults=FaultPlan(seed=0, step_fault_rate=0.002,
                         alloc_exhaust_rate=0.02, transient_alloc_rate=0.05,
                         transient_fails=2, poison_uids={3, 17}))


def live_trace(vocab):
    """(trace, serve_trace's keywords): ``[(arrival tick, Request)]``
    made with numpy from LIVE's seed; priority 1.0 and a TTFT deadline
    for every fourth uid."""
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(LIVE["seed"])
    n = LIVE["requests"] + LIVE["burst_n"]
    prefix = rng.integers(0, vocab, LIVE["prefix_len"])
    arrivals = np.cumsum(rng.exponential(1.0 / LIVE["rate"],
                                         LIVE["requests"])).tolist()
    arrivals += [LIVE["burst_at"]] * LIVE["burst_n"]
    trace = []
    for uid in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(
            LIVE["prompt_lo"], LIVE["prompt_hi"] + 1)))
        if uid % 2 == 0:
            prompt = np.concatenate([prefix, prompt])
        trace.append((float(arrivals[uid]), Request(
            uid=uid, prompt=prompt,
            max_new=int(rng.integers(LIVE["new_lo"], LIVE["new_hi"] + 1)),
            max_ticks=(LIVE["max_ticks"] if uid in LIVE["max_ticks_uids"]
                       else None))))
    urgent = range(1, n, 4)
    return trace, dict(
        priorities={uid: 1.0 for uid in urgent},
        deadlines={uid: LIVE["priority_deadline"] for uid in urgent})


def live_server(cfg, params, sc, dev):
    from repro_torch.runtime.server import Server
    return Server(cfg, params, sc, device=dev)


def serve_live(torch, dev, cfg, params, sc, trace, kw):
    """One ``serve_trace`` of fresh copies of ``trace``; the launch counts
    are read around it. Returns (server, requests, launches, wall)."""
    srv = live_server(cfg, params, sc, dev)
    fresh = [(a, dataclasses.replace(r, out=None, error=None, stats={}))
             for a, r in trace]
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    srv.serve_trace(fresh, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (srv, [r for _, r in fresh],
            {n: f.launches for n, f in wrappers.items()}, wall)


def live_schedule(srv, reqs):
    """What the run decided, all of it a function of (trace, config,
    fault plan) with no EOS: the admission order, each request's outcome
    (completed, failed or shed, by error type) and token count, and
    every ServeMetrics field but the wall-clock ones."""
    outcome = {r.uid: ("completed" if r.error is None
                       else type(r.error).__name__, len(r.out))
               for r in reqs}
    metrics = {f.name: getattr(srv.metrics, f.name)
               for f in dataclasses.fields(srv.metrics)
               if f.name not in WALL_FIELDS}
    return dict(admitted=list(srv.admitted_uids), outcome=outcome,
                metrics=metrics)


def check_live_run(srv, reqs, label):
    """Every uid counted once (completed, failed or shed); preemption,
    shedding, SLO defers and faults all seen; afterwards only the prefix
    index holds pool blocks."""
    m = srv.metrics
    done = {r.uid for r in srv._st.completed}
    failed = {r.uid for r in srv.failed}
    shed = {r.uid for r in reqs if r.error is not None
            and type(r.error).__name__ == "ServerOverloaded"}
    if (done & failed or done & shed or failed & shed
            or done | failed | shed != {r.uid for r in reqs}):
        raise AssertionError(f"{label}: uids not counted once: {len(done)} "
                             f"completed, {len(failed)} failed, {len(shed)} "
                             f"shed of {len(reqs)}")
    if (m.completed, m.shed_requests, m.cancelled + m.failed_requests) != (
            len(done), len(shed), len(failed)):
        raise AssertionError(f"{label}: counters disagree with the uids")
    for name in ("preemptions", "shed_requests", "sched_deferred",
                 "faults_injected"):
        if not getattr(m, name) > 0:
            raise AssertionError(f"{label}: {name} = {getattr(m, name)}")
    for r in srv._st.completed:
        if len(r.out) != r.max_new:
            raise AssertionError(f"{label}: uid={r.uid} {len(r.out)} tokens")
    st = srv._st
    if (any(s is not None for s in st.slots) or srv.queue_depth()
            or st.alloc.reserved or st.alloc.in_use != len(srv._prefix)):
        raise AssertionError(f"{label}: pool not clean: {st.alloc.in_use} "
                             f"in use, {len(srv._prefix)} indexed, "
                             f"{st.alloc.reserved} reserved")
    st.alloc.check(expect_reserved=0)
    return done, failed, shed


def run_live_engine(torch, dev):
    """Phase 9 (a): ``serve_trace`` of the live trace on the full-width
    bf16 GLU engine, twice; the two schedules must be equal."""
    from repro_torch.core.sparse_ops import SparsityConfig
    cfg = arch_config()
    params = full_width_params(torch, cfg, dev)
    sc = live_config(SparsityConfig(enabled=True, mode="fused",
                                    gate_threshold=0.0, autotune=False))
    trace, kw = live_trace(cfg.vocab_size)
    serve_live(torch, dev, cfg, params, sc, trace[:4], {})  # warm-up
    runs = [serve_live(torch, dev, cfg, params, sc, trace, kw)
            for _ in range(2)]
    scheds = [live_schedule(srv, reqs) for srv, reqs, _, _ in runs]
    for key in scheds[0]:
        if scheds[0][key] != scheds[1][key]:
            raise AssertionError(f"phase 9 schedules differ in {key}")
    for k, (srv, reqs, launches, wall) in enumerate(runs):
        done, failed, shed = check_live_run(srv, reqs, f"run {k}")
        m = srv.metrics
        for name in ("paged_gqa_decode_attn", "sparce_glu_mlp_fused"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched in phase 9")
        log(f"  run {k}: {len(reqs)} requests: {len(done)} completed, "
            f"{len(failed)} failed, {len(shed)} shed; "
            f"{int(m.decode_tokens)} decode tokens in {int(m.ticks)} ticks, "
            f"{1e3 * m.decode_s / m.ticks:.3f} ms per decode tick, "
            f"{m.decode_tokens / m.decode_s:.1f} decode tokens/s; prefill "
            f"{int(m.prefill_tokens)} tokens in {m.prefill_s:.3f}s; wall "
            f"{wall:.3f}s")
        log(f"  run {k}: launches: paged_gqa_decode_attn "
            f"{launches['paged_gqa_decode_attn']}, sparce_glu_mlp_fused "
            f"{launches['sparce_glu_mlp_fused']}")
    srv, reqs, launches, _ = runs[0]
    m = srv.metrics
    kinds = {}
    for r in srv.failed:
        kinds[type(r.error).__name__] = kinds.get(type(r.error).__name__,
                                                  0) + 1
    log(f"  virtual ticks: TTFT p50/p99 {m.ttft_ticks_p50:.2f}/"
        f"{m.ttft_ticks_p99:.2f}, ITL p50/p99 {m.itl_ticks_p50:.2f}/"
        f"{m.itl_ticks_p99:.2f}; SLO violations ttft="
        f"{int(m.slo_ttft_violations)} itl={int(m.slo_itl_violations)}")
    log(f"  wall clock: TTFT p50/p99 {1e3 * m.ttft_s_p50:.1f}/"
        f"{1e3 * m.ttft_s_p99:.1f} ms (queue wait included)")
    log(f"  admission {int(m.sched_admitted)} / deferred "
        f"{int(m.sched_deferred)} / forced {int(m.sched_forced)}; "
        f"preemptions {int(m.preemptions)}, restore ticks "
        f"{m.preempt_restore_ticks:.2f}; shed {int(m.shed_requests)}; "
        f"faults injected {int(m.faults_injected)}, recovered "
        f"{int(m.faults_recovered)}; failed by type {kinds}; prefix hits "
        f"{int(m.prefix_hits)}/{int(m.prefix_lookups)}, evicted "
        f"{int(m.prefix_evicted_blocks)}")
    same = sum(a.out.tolist() == b.out.tolist()
               for a, b in zip(runs[0][1], runs[1][1]))
    log(f"  schedules of the two runs equal (admission order, outcomes, "
        f"every non-wall metric) -> ok; token streams equal: "
        f"{same}/{len(reqs)}")
    return launches


def check_live_f32(torch, dev):
    """Phase 9 (b): the live trace and config on the relu engine
    (``--sparce``, ``mode="kernel"``) at full width, 2 layers, f32: the
    kernels on the card against the plain versions on the CPU. Token
    streams, admission order, outcomes and every non-wall metric equal;
    a preempted request was restored."""
    from repro_torch.core.sparse_ops import SparsityConfig
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(relu_config(), num_layers=2, dtype="float32")
    sc = live_config(SparsityConfig(enabled=True, mode="kernel",
                                    autotune=False, **SPARCE_BLOCKS))
    params = model_lib.init_params(cfg, seed=ENGINE["seed"], device=dev)
    trace, kw = live_trace(cfg.vocab_size)
    cpu = torch.device("cpu")
    (gs, greqs, glaunch, gwall), (cs, creqs, _, cwall) = [
        serve_live(torch, where, cfg, p, sc, trace, kw)
        for where, p in ((dev, params), (cpu, to_device(params, cpu)))]
    check_live_run(gs, greqs, "f32 card")
    check_live_run(cs, creqs, "f32 CPU")
    want, got = live_schedule(cs, creqs), live_schedule(gs, greqs)
    for key in want:
        if got[key] != want[key]:
            diff = ({k: (got[key][k], want[key][k]) for k in want[key]
                     if got[key][k] != want[key][k]}
                    if isinstance(want[key], dict) else "order")
            raise AssertionError(f"f32 card vs CPU: {key} differs: {diff}")
    streams = {r.uid: r.out.tolist() for r in greqs}
    if streams != {r.uid: r.out.tolist() for r in creqs}:
        raise AssertionError("f32 token streams differ, card vs CPU")
    restored = [r.uid for r in gs._st.completed
                if r.stats.get("preemptions", 0) >= 1]
    if not restored:
        raise AssertionError("no preempted request was restored")
    for name in ("relu_bitmap", "sparce_gemm_gated",
                 "paged_gqa_decode_attn"):
        if glaunch[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase 9 (b)")
    log(f"  f32 2-layer relu kernel engine: token streams, admission order, "
        f"outcomes and every non-wall metric equal card vs CPU "
        f"({int(gs.metrics.ticks)} ticks, {int(gs.metrics.preemptions)} "
        f"preemptions, restored uids {restored}) -> ok; wall card "
        f"{gwall:.3f}s, CPU {cwall:.3f}s; launches "
        f"{ {k: v for k, v in glaunch.items() if v} }")


def run_live_async(torch, dev):
    """Phase 9 (c): ``AsyncServer`` on the full-width bf16 GLU engine.
    Two client threads submit 24 requests at Poisson wall-clock gaps
    while a third streams every handle; one live and one queued request
    are cancelled; then ``shutdown``. Streamed tokens equal each
    result's, the cancelled handles raise ``RequestCancelled``, the pool
    is clean. Prints the wall-clock TTFT and inter-token gaps."""
    import queue
    import threading
    from repro_torch.core.sparse_ops import SparsityConfig
    from repro_torch.runtime.errors import RequestCancelled
    from repro_torch.runtime.server import AsyncServer
    cfg = arch_config()
    params = full_width_params(torch, cfg, dev)
    sc = dataclasses.replace(
        live_config(SparsityConfig(enabled=True, mode="fused",
                                   gate_threshold=0.0, autotune=False)),
        faults=None, max_queue_depth=None)
    trace, _ = live_trace(cfg.vocab_size)
    reqs = [r for _, r in trace[:24]]
    asrv = AsyncServer(cfg, params, sc, device=dev, start=False)
    srv = asrv.server
    # The live cancel: a priority-1.0 request (no victim of a
    # preemption), cancelled from the token hook at its second token.
    cancel_live, cancel_queued = 1, reqs[-1].uid
    stamps, emit, live_cancelled = {}, srv.on_token, []

    def stamped(r, tok):
        stamps.setdefault(r.uid, []).append(time.perf_counter())
        emit(r, tok)
        if r.uid == cancel_live and len(stamps[r.uid]) == 2:
            with asrv._lock:
                h = asrv._handles[r.uid]
            live_cancelled.append(asrv.cancel(h))

    srv.on_token = stamped
    handles: "queue.Queue" = queue.Queue()
    errors, streamed, outcome = [], {}, {}

    def client(part, seed):
        rng = np.random.default_rng(seed)
        for r in part:
            time.sleep(float(rng.exponential(0.02)))
            h = asrv.submit(r.prompt, max_new=r.max_new, uid=r.uid,
                            priority=1.0 if r.uid % 4 == 1 else 0.0)
            if r.uid == cancel_queued:
                asrv.cancel(h)  # 23 requests ahead of it, 8 slots
            handles.put(h)

    def streamer():
        for _ in reqs:
            h = handles.get(timeout=WAIT_S)
            toks = []
            try:
                for tok in asrv.stream(h, timeout=WAIT_S):
                    toks.append(int(tok))
                outcome[h.uid] = "completed"
            except RequestCancelled as e:
                outcome[h.uid] = str(e)
            streamed[h.uid] = (h, toks)

    def guarded(fn, *a):
        try:
            fn(*a)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    first = [r for r in reqs if r.uid != cancel_queued]
    threads = [threading.Thread(target=guarded, args=a, daemon=True) for a in
               ((client, first[0::2], 1), (client, first[1::2] + [reqs[-1]],
                                           2), (streamer,))]
    t0 = time.perf_counter()
    asrv.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        if t.is_alive():
            raise AssertionError("a phase 9 (c) thread hung")
    if errors:
        raise errors[0]
    asrv.drain(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    asrv.shutdown(timeout=WAIT_S)
    if asrv._thread.is_alive():
        raise AssertionError("the engine thread did not stop")
    launches = {n: f.launches for n, f in wrappers.items()}
    for uid, (h, toks) in streamed.items():
        out = h.request.out.tolist()
        if toks != out:
            raise AssertionError(f"uid={uid}: streamed {toks} != out {out}")
        if uid in (cancel_live, cancel_queued):
            try:
                h.result(timeout=WAIT_S)
                raise AssertionError(f"uid={uid} was not cancelled")
            except RequestCancelled:
                pass
        elif len(h.result(timeout=WAIT_S).out) != h.request.max_new:
            raise AssertionError(f"uid={uid}: budget not served")
    if "queued" not in outcome[cancel_queued] or streamed[cancel_queued][1]:
        raise AssertionError(f"uid={cancel_queued}: "
                             f"{outcome[cancel_queued]}")
    if (live_cancelled != [True] or "mid-decode" not in outcome[cancel_live]
            or len(streamed[cancel_live][1]) < 2):
        raise AssertionError(f"uid={cancel_live}: {outcome[cancel_live]}")
    m = asrv.metrics
    if m.cancelled != 2 or m.completed != len(reqs) - 2:
        raise AssertionError(f"{int(m.completed)} completed, "
                             f"{int(m.cancelled)} cancelled")
    st = srv._st
    if (st.alloc.reserved or st.alloc.in_use != len(srv._prefix)
            or any(s is not None for s in st.slots)):
        raise AssertionError("AsyncServer: pool not clean")
    st.alloc.check(expect_reserved=0)
    for name in ("paged_gqa_decode_attn", "sparce_glu_mlp_fused"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase 9 (c)")
    gaps = [1e3 * (b - a) for ts in stamps.values()
            for a, b in zip(ts, ts[1:])]
    log(f"  AsyncServer: {len(reqs)} submitted from 2 threads, "
        f"{int(m.completed)} completed, 2 cancelled (one queued, one "
        f"mid-decode); streams equal results; pool clean -> ok; "
        f"{int(m.decode_tokens)} decode tokens in {int(m.ticks)} ticks, "
        f"{1e3 * m.decode_s / m.ticks:.3f} ms per decode tick, wall "
        f"{wall:.3f}s; preemptions {int(m.preemptions)}")
    log(f"  AsyncServer wall clock: TTFT p50/p99 {1e3 * m.ttft_s_p50:.1f}/"
        f"{1e3 * m.ttft_s_p99:.1f} ms; inter-token gap p50/p99 "
        f"{np.percentile(gaps, 50):.1f}/{np.percentile(gaps, 99):.1f} ms "
        f"({len(gaps)} gaps)")
    log(f"  AsyncServer launches: "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# ------------------------------------------ phase 10: contiguous layout
# mamba2-2.7b cut to 32 of its 64 layers (whole before phase 17 took its
# share of the script's time); zamba2-7b at its published widths cut to
# 15 of 81 layers: 2 super-groups of 6 mamba2 layers, each followed by
# the one shared attention+MLP block, and 3 trailing mamba2 layers.
SSM_DEPTHS = {"mamba2-2.7b": dict(num_layers=32),
              "zamba2-7b": dict(num_layers=15)}
# The four configs that need no new model code, at their published
# widths; depth (layers kept) cut to fit one card and the run's time.
NEW_DEPTHS = {"smollm-360m": None, "mistral-nemo-12b": 4,
              "qwen1.5-110b": 2, "qwen2-moe-a2.7b": 4}
# Their short seeded trace: 8 requests, prompts 16-64, 8 new tokens.
SHORT = dict(ENGINE, requests=8, prompt_lo=16, prompt_hi=64, max_new=8,
             max_len=128)


def glu_variant(cfg, rows):
    """The planner's variant for ``cfg``'s GLU MLP at ``rows`` rows
    under phase 4's sparsity (what ``mlp_fwd`` will run)."""
    from repro_torch.core import sasa
    sp = glu_sparsity()
    return sasa.plan_glu_mlp_cached(
        rows, cfg.d_model, cfg.d_ff, cfg.d_model,
        measured_block_sparsity=sp.expected_sparsity, dtype=cfg.dtype,
        block_m=sp.block_m, block_f=sp.block_k,
        block_n=sp.block_n).variant


def peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2**30


def run_contiguous_glu(torch, dev, paged_metrics):
    """Phase 4's config and trace on the contiguous layout (the gather
    path): its ticks, decode tokens and skip counters must equal phase
    4's paged engine's (``paged_metrics``; phase 4 runs here when it was
    not run). Returns the launches."""
    cfg = arch_config()
    if paged_metrics is None:
        paged_metrics, _ = run_glu_engine(torch, dev)
    params = full_width_params(torch, cfg, dev)
    m, launches = run_engine(
        torch, dev, cfg, params, glu_sparsity(), "glu fused contiguous",
        ("sparce_glu_mlp_fused",), kv_block_size=0)
    for name in SKIP_COUNTERS:
        a, b = getattr(paged_metrics, name), getattr(m, name)
        if a != b:
            raise AssertionError(f"{name}: paged {a} != contiguous {b}")
    log(f"  glu contiguous vs paged (phase 4): {', '.join(SKIP_COUNTERS)} "
        "equal -> ok")
    return launches


def ssm_step_params(cfg, params):
    """The f32 2-layer step's config and weights, cut from the engine's
    bf16 weights (upcast afterwards): mamba2's first 2 layers; for
    zamba2, its first 2 mamba2 layers with ``attn_every`` cut from 6 to
    1, so the step holds 2 applications of the shared block, each over
    its own KV cache."""
    if cfg.family == "ssm":
        return (dataclasses.replace(cfg, num_layers=2, dtype="float32"),
                dict(params, stack=params["stack"][:2]))
    hyb = params["hybrid"]
    layers = hyb["groups"][0][:2]
    return (dataclasses.replace(cfg, num_layers=2, attn_every=1,
                                dtype="float32"),
            dict(params, hybrid={"groups": [[lp] for lp in layers],
                                 "shared_attn": hyb["shared_attn"]}))


def check_contiguous_step(torch, dev, cfg, params, label):
    """One f32 ``serving_decode_step`` over contiguous caches (random
    states and windows, ragged KV lengths, two dead slots) on the card
    against the same step on a CPU copy: logits of the live slots and
    every cache leaf within 1e-3."""
    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(4)
    lengths = [0, 3, 16, 31, 64, 100, 0, 127]
    B = len(lengths)
    caches = model_lib.init_caches(cfg, B, 128, device=dev)
    for leaf in model_lib.cache_leaves(caches):
        if leaf.dtype == torch.int32:  # per-slot lengths
            leaf.copy_(torch.tensor(lengths, dtype=torch.int32).expand(
                leaf.shape))
        else:
            leaf.copy_(torch.from_numpy(rng.standard_normal(
                tuple(leaf.shape), dtype=np.float32)))
    active = np.array([n > 0 for n in lengths], np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 1))
    cpu = torch.device("cpu")
    outs = []
    for where, p, c in ((dev, params, caches),
                        (cpu, to_device(params, cpu),
                         to_device(caches, cpu))):
        with torch.no_grad():
            logits, nc, _ = model_lib.serving_decode_step(
                p, cfg, torch.from_numpy(toks).to(where), c,
                torch.from_numpy(active).to(where))
        outs.append((logits[:, -1].float().cpu(),
                     [t.cpu() for t in model_lib.cache_leaves(nc)]))
    (lg, cg), (lc, cc) = outs
    live = torch.from_numpy(active).bool()
    why = "2 layers of f32 sums in another order"
    check_close(f"{label}: f32 serving_decode_step logits (live slots), "
                "GPU vs CPU", lg[live], lc[live], atol=1e-3, rtol=1e-3,
                why=why)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(cg, cc))
    if not all(torch.allclose(a.float(), b.float(), atol=1e-3, rtol=1e-3)
               for a, b in zip(cg, cc)):
        raise AssertionError(f"{label}: caches differ (max {err:.3e})")
    log(f"  {label}: {len(cg)} cache leaves equal within 1e-3 "
        f"(max_abs_err={err:.3e}) -> ok")


def run_ssm_engines(torch, dev):
    """mamba2-2.7b (32 layers) and zamba2-7b (15 layers) as full-width bf16
    engines on the mixed-budget trace (contiguous caches), then an f32
    2-layer decode step of each, card against CPU. Returns
    {arch: launches}."""
    from repro_torch.configs import get_config
    out = {}
    for arch, depth in SSM_DEPTHS.items():
        cfg = dataclasses.replace(get_config(arch), **depth)
        t0 = time.perf_counter()
        expect = ()
        if cfg.family == "hybrid":
            plans = {rows: glu_variant(cfg, rows) for rows in (8, 256)}
            log(f"  {arch}: shared block's GLU (K=N={cfg.d_model}, "
                f"F={cfg.d_ff}): the planner picks {plans[8]!r} at 8 rows, "
                f"{plans[256]!r} at 256")
            if plans[8] == "fused":
                expect = ("sparce_glu_mlp_fused",)
        torch.cuda.reset_peak_memory_stats()
        params = full_width_params(torch, cfg, dev)
        _, launches = run_engine(torch, dev, cfg, params, glu_sparsity(),
                                 arch, expect, mixed=True)
        log(f"  {arch}: peak device memory {peak_gib(torch):.2f} GiB")
        if not expect:
            if any(launches.values()):
                raise AssertionError(f"{arch}: a kernel launched: "
                                     f"{launches}")
            log(f"  {arch}: no launch of the nine kernels: its path (the "
                "mamba2 mixer, no attention, no MLP) holds none of them")
        out[arch] = launches
        cfg2, params2 = ssm_step_params(cfg, params)
        del params
        upcast_in_place(torch, params2)
        check_contiguous_step(torch, dev, dataclasses.replace(
            cfg2, sparsity=glu_sparsity()), params2, f"{arch} 2-layer")
        del params2
        torch.cuda.empty_cache()
        log(f"  {arch}: {time.perf_counter() - t0:.1f}s")
    return out


def run_new_configs(torch, dev):
    """The four configs that need no new model code as full-width bf16
    paged engines (paged GQA kernel) on the short trace: every request
    completes its budget with in-vocab tokens, the GQA kernel launches.
    Returns {arch: launches}."""
    from repro_torch.configs import get_config
    out = {}
    for arch, layers in NEW_DEPTHS.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        expect = ("paged_gqa_decode_attn",)
        if cfg.moe is None:
            variant = glu_variant(cfg, SHORT["slots"])
            log(f"  {arch} ({cfg.num_layers} layers): GLU K={cfg.d_model} "
                f"F={cfg.d_ff}: the planner picks {variant!r} at "
                f"{SHORT['slots']} rows")
            if variant == "fused":
                expect += ("sparce_glu_mlp_fused",)
        else:
            log(f"  {arch} ({cfg.num_layers} layers): MoE layers only "
                f"({cfg.moe.num_experts} routed + "
                f"{cfg.moe.n_shared_experts} shared experts, top "
                f"{cfg.moe.top_k})")
        torch.cuda.reset_peak_memory_stats()
        params = full_width_params(torch, cfg, dev)
        _, out[arch] = run_engine(torch, dev, cfg, params, glu_sparsity(),
                                  arch, expect, trace=SHORT, profile=False)
        del params
        torch.cuda.empty_cache()
        log(f"  {arch}: peak device memory {peak_gib(torch):.2f} GiB; "
            f"{time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------- phase 11: the frontends
# The vlm and audio archs at their published widths; depth (layers kept)
# cut where the run's time asks for it.
FRONTEND_DEPTHS = {"musicgen-large": None, "pixtral-12b": 8}


def run_frontends(torch, dev):
    """musicgen-large whole and pixtral-12b (8 layers) as full-width bf16
    paged engines on the short trace: musicgen's prompts are 4 codebook
    streams, pixtral's run behind 1024 patch rows a slot; every request
    completes its budget with in-vocab tokens, the GQA kernel launches
    (and the GLU kernel where the planner picks ``fused``). Then an f32
    2-layer decode step of each, cut from those weights, card against
    CPU. Returns {arch: launches}."""
    from repro_torch.configs import get_config
    out = {}
    for arch, layers in FRONTEND_DEPTHS.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        patches = cfg.num_patches if cfg.frontend == "patches" else 0
        rows = (SHORT["slots"], patches + SHORT["prompt_hi"])
        plans = {r: glu_variant(cfg, r) for r in rows}
        log(f"  {arch} ({cfg.num_layers} layers, {cfg.mlp_act} GLU "
            f"K={cfg.d_model} F={cfg.d_ff}; attention {cfg.num_kv_heads} "
            f"KV heads of group {cfg.num_heads // cfg.num_kv_heads}, "
            f"head_dim {cfg.resolved_head_dim}; {patches} patch rows, "
            f"{cfg.num_codebooks} codebooks): the planner picks "
            f"{plans[rows[0]]!r} at {rows[0]} rows, {plans[rows[1]]!r} at "
            f"{rows[1]}")
        expect = ("paged_gqa_decode_attn",)
        if "fused" in plans.values():
            expect += ("sparce_glu_mlp_fused",)
        torch.cuda.reset_peak_memory_stats()
        params = full_width_params(torch, cfg, dev)
        _, out[arch] = run_engine(torch, dev, cfg, params, glu_sparsity(),
                                  arch, expect, trace=SHORT, profile=False)
        log(f"  {arch}: peak device memory {peak_gib(torch):.2f} GiB")
        cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                   sparsity=glu_sparsity())
        params2 = dict(params, stack=params["stack"][:2])
        del params
        upcast_in_place(torch, params2)
        compare_decode_step(torch, dev, cfg2, params2, f"{arch} 2-layer",
                            why="2 layers of f32 sums in another order")
        del params2
        torch.cuda.empty_cache()
        log(f"  {arch}: {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------- timing a slice's new kernel shapes
# A row: (label, kernel call, plain version, library call, the kernel's
# device names, bytes the call must move, its operations, iterations).
def time_rows(torch, dev, rows, path="bfloat16"):
    """Each row's kernel beside its plain version (CUDA events), the
    library call's device time by both witnesses, and its bound at
    ``path``'s peak rate, logged. Returns {label: device ms over the
    library's}."""
    out = {}
    for label, run, plain, library, names, nbytes, ops, iters in rows:
        plain_ms = cuda_time_ms(plain, 10)
        dev_ms, _, lib_dev_ms, _ = log_device_witnesses(
            label, cuda_time_ms(run, iters), run,
            cuda_time_ms(library, iters), library, names)
        bound_ms, by = bound(nbytes, ops, path)
        log(f"  {label}: plain {plain_ms:.4f} ms (events); bound "
            f"{bound_ms:.5f} ms ({by}); device over the library's "
            f"{dev_ms / lib_dev_ms:.2f}x")
        out[label] = dev_ms / lib_dev_ms
    return out


def bf16_normal(torch, dev, rng, *shape, scale=1.0):
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return torch.from_numpy(a).to(dev, torch.bfloat16)


def gqa_row(torch, dev, label, *, KV, g, D):
    """The bf16 GQA kernel at (KV heads, group, head_dim) over the
    trace's lengths."""
    from repro_torch.kernels import paged_decode_attn as pda
    bs, item = ENGINE["block_size"], 2
    lengths = np.asarray(trace_lengths())
    c = attn_case(torch, dev, torch.bfloat16, seed=5,
                  lengths=lengths.tolist(), max_blocks=32, KV=KV, g=g, D=D)
    args = (c["q"], c["k"], c["v"], c["tables"], c["lengths"])
    live_blocks = int(sum(-(-int(n) // bs) for n in lengths))
    return (label, lambda: pda.paged_gqa_decode_attn(*args),
            lambda: pda.paged_gqa_decode_attn_plain(*args),
            gqa_library(torch, c), GQA_KERNELS,
            2 * len(lengths) * KV * g * D * item
            + 2 * live_blocks * bs * KV * D * item + live_blocks * 4
            + len(lengths) * 4,
            4 * int(lengths.sum()) * KV * g * D, 200)


def glu_row(torch, dev, rng, label, *, M, K, F_, N, act):
    """The bf16 gated-GLU kernel at init scales, every stripe live."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_glu_mlp as sgm
    x = bf16_normal(torch, dev, rng, M, K)
    wg = bf16_normal(torch, dev, rng, K, F_, scale=K ** -0.5)
    wi = bf16_normal(torch, dev, rng, K, F_, scale=K ** -0.5)
    wo = bf16_normal(torch, dev, rng, F_, N, scale=F_ ** -0.5)
    kw = dict(block_m=64, block_f=128, act=act)
    gate = ((lambda h: F.gelu(h, approximate="tanh")) if act == "gelu"
            else F.silu)
    return (label, lambda: kops.sparce_glu_mlp_fused(x, wg, wi, wo, **kw),
            lambda: sgm.sparce_glu_mlp_fused_plain(x, wg, wi, wo, **kw),
            lambda: (gate(x @ wg) * (x @ wi)) @ wo, GLU_KERNELS,
            (x.numel() + 3 * K * F_ + 2 * M * N) * 2, 6 * M * K * F_, 100)


def phase10_rows(torch, dev):
    """The two kernels at the widest shapes phase 10 gives them: the
    gated GLU at zamba2-7b's shared block (a decode tick of 8 rows,
    K = N = 3584, F = 14336) and the GQA kernel at qwen1.5-110b's heads
    (8 KV heads of 8 query rows, head_dim 128)."""
    rng = np.random.default_rng(6)
    return [glu_row(torch, dev, rng, "sparce_glu_mlp_fused zamba2-7b decode",
                    M=ENGINE["slots"], K=3584, F_=14336, N=3584, act="silu"),
            gqa_row(torch, dev, "paged_gqa_decode_attn qwen1.5-110b heads",
                    KV=8, g=8, D=128)]


def slice_rows(torch, dev):
    """The kernels at the shapes phases 11 and 12 first give them: the
    GQA kernel at musicgen-large's heads (32 KV heads of group 1,
    head_dim 64); the GLU kernel's gelu at musicgen's decode (8 rows,
    K = N = 2048, F = 8192); the fused relu MLP at a training step's
    8 x 512 rows; the gated GEMM at the step's FP, BP and WG shapes (30%
    of the gated operand's tiles zero; FP is the row added beside BP and
    WG with the tall path, 600 launches in phase 12's GLU kernel run)."""
    from repro_torch.core import sprf
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_gemm as sg
    from repro_torch.kernels import sparce_mlp as sm
    rng = np.random.default_rng(7)
    rows = [gqa_row(torch, dev, "paged_gqa_decode_attn musicgen-large heads",
                    KV=32, g=1, D=64),
            glu_row(torch, dev, rng,
                    "sparce_glu_mlp_fused gelu musicgen-large decode",
                    M=ENGINE["slots"], K=2048, F_=8192, N=2048, act="gelu")]

    M, K, F_, N = TRAIN["batch"] * TRAIN["seq"], 576, 1536, 576
    x = bf16_normal(torch, dev, rng, M, K)
    wi = bf16_normal(torch, dev, rng, K, F_, scale=K ** -0.5)
    wo = bf16_normal(torch, dev, rng, F_, N, scale=F_ ** -0.5)
    mkw = dict(block_m=64, block_f=128, act="relu")
    rows.append(("sparce_mlp_fused training forward (8 x 512 rows)",
                 lambda: kops.sparce_mlp_fused(x, wi, wo, **mkw),
                 lambda: sm.sparce_mlp_fused_plain(x, wi, wo, **mkw),
                 lambda: torch.relu(x @ wi) @ wo, MLP_KERNELS,
                 (M * K + K * F_ + F_ * N + M * N) * 2,
                 2 * M * K * F_ + 2 * M * F_ * N, 100))

    a, w, gr, (bm, bk, bn) = train_gemm_operands(torch, torch.bfloat16, 9)
    a, w, gr = a.to(dev), w.to(dev), gr.to(dev)
    abits = sprf.compute_bitmap(a, (bm, bk)).bits
    gbits = sprf.compute_bitmap(gr, (bm, bn)).bits
    for label, lhs, rhs, bits, (pm, pk, pn) in (
            ("FP", a, w, abits, (bm, bk, bn)),
            ("BP", gr, w.T.contiguous(), gbits, (bm, bn, bk)),
            ("WG", a.T.contiguous(), gr, abits.T.contiguous(),
             (bk, bm, bn))):
        kw = dict(block_m=pm, block_k=pk, block_n=pn, gate="lhs")
        live = int(bits.numel() - bits.sum())
        Mx, Kx = lhs.shape
        Nx = rhs.shape[1]
        rows.append((
            f"sparce_gemm_gated training {label} {tuple(lhs.shape)} @ "
            f"{tuple(rhs.shape)}",
            lambda lhs=lhs, rhs=rhs, bits=bits, kw=kw:
                sg.sparce_gemm_gated(lhs, rhs, bits, **kw),
            lambda lhs=lhs, rhs=rhs, bits=bits, kw=kw:
                sg.sparce_gemm_gated_plain(lhs, rhs, bits, **kw),
            lambda lhs=lhs, rhs=rhs: lhs @ rhs, GEMM_KERNELS,
            (live * pm * pk + Kx * Nx + Mx * Nx) * 2 + bits.numel() * 4,
            2 * live * pm * pk * Nx, 100))
    return rows


def tall_kernel_rows(torch, dev):
    """The kernels-line rows of the two tall paths, with their launches
    in phase 12's runs: the gated GEMM at row 5b's BP ``g @ w_out^T``
    (4096 x 576 @ 576 x 1536, error tiles (64, 128), 30% gated) and the
    fused relu MLP at row 3b's forward (4096 rows, tiles (64, 128)). The
    bounds count the live tiles' operands and products only."""
    from repro_torch.core import sprf
    from repro_torch.kernels import sparce_gemm as sg
    from repro_torch.kernels import sparce_mlp as sm
    _, w, gr, (bm, bk, bn) = train_gemm_operands(torch, torch.bfloat16, 9)
    lhs, rhs = gr.to(dev), w.T.contiguous().to(dev)
    bits = sprf.compute_bitmap(lhs, (bm, bn)).bits
    kw = dict(block_m=bm, block_k=bn, block_n=bk)
    run = lambda: sg.sparce_gemm_gated(lhs, rhs, bits, **kw)  # noqa: E731
    plain = lambda: sg.sparce_gemm_gated_plain(  # noqa: E731
        lhs, rhs, bits, **kw)
    M, K = lhs.shape
    N = rhs.shape[1]
    live = int(bits.numel() - bits.sum())
    live_k = int((bits == 0).any(dim=0).sum())
    row_g = kernel_row(
        "sparce_gemm_gated (tall path)", "tall_gemm.cuh",
        "src/repro/kernels/sparce_gemm.py:123",
        TALL_ERRS.get("sparce_gemm_gated"), cuda_time_ms(run, 100),
        cuda_time_ms(plain, 3, warmup=1), cuda_time_ms(lambda: lhs @ rhs,
                                                       100),
        2 * (live * bm * bn + live_k * bn * N + M * N) + 4 * bits.numel(),
        2 * live * bm * bn * N,
        f"training BP {tuple(lhs.shape)} @ {tuple(rhs.shape)}, tiles ({bm},"
        f" {bn}), {live} live tiles, plan "
        f"{sg.tall_plan(M, K, N, block_m=bm, block_k=bn, dtype=lhs.dtype)}"
        " (g @ w_out^T as the library call)")
    row_g["launches"] = TALL_LAUNCHES["glu kernel"]["sparce_gemm_gated"]

    rng = np.random.default_rng(7)
    M, K, F_, N = TRAIN["batch"] * TRAIN["seq"], 576, 1536, 576
    x = bf16_normal(torch, dev, rng, M, K)
    wi = bf16_normal(torch, dev, rng, K, F_, scale=K ** -0.5)
    wo = bf16_normal(torch, dev, rng, F_, N, scale=F_ ** -0.5)
    mkw = dict(block_m=64, block_f=128)
    run = lambda: sm.sparce_mlp_fused(x, wi, wo, **mkw)  # noqa: E731
    _, mbits = run()
    live = int((mbits == 0).sum())
    live_f = int((mbits == 0).any(dim=0).sum())
    row_m = kernel_row(
        "sparce_mlp_fused (tall path)", "sparce_mlp.cu",
        "src/repro/kernels/sparce_mlp.py:111",
        TALL_ERRS.get("sparce_mlp_fused"), cuda_time_ms(run, 100),
        cuda_time_ms(lambda: sm.sparce_mlp_fused_plain(x, wi, wo, **mkw), 3,
                     warmup=1),
        cuda_time_ms(lambda: torch.relu(x @ wi) @ wo, 100),
        2 * (M * K + K * F_ + live_f * 128 * N + M * N) + 4 * mbits.numel(),
        2 * M * K * F_ + 2 * live * 64 * 128 * N,
        f"training forward x=({M}, {K}) F={F_} N={N} tiles (64, 128), "
        f"{live} live tiles (relu(x@w_in)@w_out as the library call)")
    row_m["launches"] = TALL_LAUNCHES["relu fused"]["sparce_mlp_fused"]
    return [row_g, row_m]


# ------------------------------------------ phase 13: serving on a mesh
# Every rank on card 0 over gloo: the machine has one card, and NCCL
# refuses two ranks on one device. Each rank waits at most this long in
# any collective; a spawn at most MESH_DEADLINE_S.
MESH_TIMEOUT_S = 60.0
MESH_DEADLINE_S = 400.0
# Phase 4's 16 requests on its 8 slots, so queued requests are admitted
# into freed slots (and their KV blocks) mid-run, at 8 new tokens each
# (32 before phase 17 took its share of the script's time).
MESH_TRACE = dict(ENGINE, max_new=8)
# (label, mesh, engine): the bf16 GLU engine (phase 4's) on (1, 3), the
# bf16 --sparce relu engine (phase 5's, both modes) on (2, 1); then each
# mesh's f32 2-layer engine, held to the single-rank one bit for bit.
MESH_RUNS = (
    ((1, 3), ("glu", "glu f32")),
    ((2, 1), ("relu fused", "relu kernel", "relu kernel f32")),
)
# Each engine's kernels: every rank launches each of them in its run.
MESH_EXPECT = {
    "glu": ("paged_gqa_decode_attn", "sparce_glu_mlp_fused"),
    "relu fused": ("paged_gqa_decode_attn", "sparce_mlp_fused"),
    "relu kernel": ("paged_gqa_decode_attn", "relu_bitmap",
                    "sparce_gemm_gated"),
}
MESH_PARITY_KEYS = (
    "prefill_tokens", "decode_tokens", "ticks", "admitted", "completed",
    "skipped_tile_dots", "total_tile_dots", "mlp_skip_fraction",
    "attn_blocks_fetched", "attn_blocks_total", "attn_block_skip_fraction",
    "kv_blocks_peak_in_use", "modeled_hbm_bytes_saved",
    "modeled_attn_bytes_saved",
)


def mesh_engine(name):
    """(cfg, sparsity, mixed budgets) of a phase 13 engine: full width in
    bf16; the ``f32`` ones at 2 layers."""
    from repro_torch.core.sparse_ops import SparsityConfig
    kind = name.replace(" f32", "")
    if kind == "glu":
        cfg, sp, mixed = arch_config(), glu_sparsity(), False
    else:
        cfg, mixed = relu_config(), True
        sp = SparsityConfig(enabled=True, mode=kind.split()[1],
                            autotune=False, **SPARCE_BLOCKS)
    if name.endswith("f32"):
        cfg = dataclasses.replace(cfg, dtype="float32", num_layers=2)
    return cfg, sp, mixed


def serve_mesh_engine(name, mesh, device):
    """Serve phase 13's trace on engine ``name`` (phase 4's requests at
    MESH_TRACE's budget; phase 5's mixed budgets for relu) on this process (``mesh`` None) or
    as rank 0 of a running mesh. Returns the tokens, metrics, this
    process's launches and (on a mesh) collectives' counters, and the
    wall time of the run."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.parallel import collectives
    from repro_torch.runtime.server import ServeConfig, Server
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cfg, sp, mixed = mesh_engine(name)
    params = model_lib.init_params(cfg, seed=ENGINE["seed"], device=dev)
    sc = ServeConfig(batch_slots=ENGINE["slots"], max_len=ENGINE["max_len"],
                     kv_block_size=ENGINE["block_size"], attn_kernel="paged",
                     sparsity=sp, mesh=mesh)
    srv = Server(cfg, params, sc, device=dev)
    reqs = engine_requests(cfg, MESH_TRACE["requests"], seed=ENGINE["seed"],
                           mixed=mixed, trace=MESH_TRACE)
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    if mesh is not None:
        collectives.reset_stats()
    t0 = time.perf_counter()
    done = srv.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(
        name=name, tokens={r.uid: np.asarray(r.out).tolist() for r in done},
        metrics=dataclasses.asdict(srv.metrics),
        launches={k: fn.launches for k, fn in wrappers.items()},
        collectives=collectives.stats() if mesh is not None else None,
        wall=wall)


def mesh_driver(names, mesh, device):
    """Rank 0 of a phase 13 mesh (or the single rank, ``mesh`` None): a
    short warm-up engine (library loads, cuBLAS handles, the collectives'
    first connections), then each engine in turn."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.server import ServeConfig, Server
    cfg, sp, _ = mesh_engine(names[0])
    dev = torch.device(device)
    with drawn_on_card(torch):  # the workers take rank 0's params
        Server(cfg, model_lib.init_params(cfg, seed=1, device=dev),
               ServeConfig(batch_slots=ENGINE["slots"],
                           max_len=ENGINE["max_len"],
                           kv_block_size=ENGINE["block_size"],
                           attn_kernel="paged", sparsity=sp, mesh=mesh),
               device=dev).generate(engine_requests(cfg, 2, seed=99))
        return [serve_mesh_engine(n, mesh, device) for n in names]


def log_collectives(label, who, c, ticks):
    secs = sum(c["seconds"].values())
    log(f"  {label} {who} collectives: "
        + ", ".join(f"{k} {c['counts'][k]} calls / {c[k]} B / "
                    f"{c['seconds'][k]:.3f}s" for k in c["counts"]
                    if c["counts"][k])
        + f"; {secs:.3f}s in all, {1e3 * secs / max(ticks, 1):.3f} ms "
          "per decode tick")


def run_mesh_engines(torch, dev):
    """Phase 13: the single-rank engines on this process, then each mesh
    of MESH_RUNS spawned on card 0 (gloo) with its engines served by rank
    0; returns {label: {rank: launches}}."""
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.parallel.worker import serve_rank
    single = {}
    for _, names in MESH_RUNS:
        for got in mesh_driver(names, None, str(dev)):
            single[got["name"]] = got
            m = got["metrics"]
            log(f"  {got['name']} single rank: {int(m['ticks'])} ticks, "
                f"{int(m['decode_tokens'])} decode tokens, "
                f"{1e3 * m['decode_s'] / m['ticks']:.3f} ms per decode tick")
    torch.cuda.synchronize()
    launches = {}
    rank_dev = str(dev) if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    for mesh, names in MESH_RUNS:
        t0 = time.perf_counter()
        outs = spawn_mesh(serve_rank, mesh,
                          (mesh_driver, (names, mesh, rank_dev), rank_dev),
                          device=rank_dev, backend="gloo",
                          timeout_s=MESH_TIMEOUT_S,
                          deadline_s=MESH_DEADLINE_S)
        log(f"  mesh {mesh}: {mesh[0] * mesh[1]} ranks on card 0 (gloo), "
            f"spawn to exit {time.perf_counter() - t0:.1f}s")
        for i, (got, name) in enumerate(zip(outs[0], names)):
            check_mesh_engine(got, single[name], mesh, outs, i)
            label = f"{name} {mesh}"
            launches[label] = {0: got["launches"]}
            launches[label].update({r: outs[r][i + 1]["launches"]
                                    for r in range(1, len(outs))})
    return launches


def check_mesh_engine(got, want, mesh, outs, i):
    """One phase 13 engine against its single-rank run: the schedule
    (ticks, admissions, decode tokens) always, more requests admitted
    than there are slots; f32: every token and parity counter. Every rank launched the engine's kernels, the GQA
    kernel exactly once a layer a decode tick."""
    name, m, w = got["name"], got["metrics"], want["metrics"]
    label = f"{name} {mesh}"
    for k in (MESH_PARITY_KEYS if name.endswith("f32")
              else ("ticks", "admitted", "decode_tokens", "completed")):
        if m[k] != w[k]:
            raise AssertionError(f"{label}: {k} {m[k]} != single rank {w[k]}")
    if name.endswith("f32"):
        if got["tokens"] != want["tokens"]:
            bad = [u for u in want["tokens"]
                   if got["tokens"].get(u) != want["tokens"][u]]
            raise AssertionError(f"{label}: streams differ for uids {bad}")
        log(f"  {label}: {len(got['tokens'])} f32 streams and "
            f"{', '.join(MESH_PARITY_KEYS)} equal the single rank's -> ok")
    if not m["admitted"] > ENGINE["slots"]:
        raise AssertionError(f"{label}: {int(m['admitted'])} admitted on "
                             f"{ENGINE['slots']} slots: no request was "
                             "admitted into a freed slot")
    if (m["mesh_data"], m["mesh_model"]) != tuple(map(float, mesh)):
        raise AssertionError(f"{label}: mesh metrics {m['mesh_data']}, "
                             f"{m['mesh_model']}")
    cfg, _, _ = mesh_engine(name)
    per_rank = [got["launches"]] + [o[i + 1]["launches"] for o in outs[1:]]
    for r, lz in enumerate(per_rank):
        for k in MESH_EXPECT[name.replace(" f32", "")]:
            if lz[k] <= 0:
                raise AssertionError(f"{label}: rank {r} never launched {k}")
        if lz["paged_gqa_decode_attn"] != m["ticks"] * cfg.num_layers:
            raise AssertionError(
                f"{label}: rank {r} launched the GQA kernel "
                f"{lz['paged_gqa_decode_attn']} times, not "
                f"{int(m['ticks'])} ticks x {cfg.num_layers} layers")
    ticks = int(m["ticks"])
    log(f"  {label}: {ticks} ticks, {int(m['admitted'])} admitted, "
        f"{int(m['decode_tokens'])} decode tokens (equal to the single "
        f"rank's); {1e3 * m['decode_s'] / ticks:.3f} ms per decode tick "
        f"(single rank {1e3 * want['metrics']['decode_s'] / ticks:.3f}); "
        f"prefill {m['prefill_s']:.3f}s (single rank "
        f"{want['metrics']['prefill_s']:.3f}s); wall {got['wall']:.3f}s; "
        f"mlp_skip_fraction {m['mlp_skip_fraction']:.4f} "
        f"(single rank {w['mlp_skip_fraction']:.4f})")
    log_collectives(label, "rank 0", got["collectives"], ticks)
    for r, o in enumerate(outs[1:], start=1):
        log_collectives(label, f"rank {r}", o[i + 1]["collectives"], ticks)
    for r, lz in enumerate(per_rank):
        log(f"  {label} rank {r} launches: "
            f"{ {k: v for k, v in lz.items() if v} }")


def phase13_rows(torch, dev):
    """The path's kernels at the shapes a mesh shard gives them: the GQA
    kernel at 1 KV head of group 3 (smollm-135m at tp 3), the gated GLU
    at 8 rows and F 512, and the fused relu MLP at 4 rows (a data
    shard's slots at dp 2, block_m 1)."""
    from repro_torch.kernels import sparce_mlp as sm
    rng = np.random.default_rng(8)
    rows = [gqa_row(torch, dev, "paged_gqa_decode_attn tp 3 shard (1 KV "
                    "head of 3)", KV=1, g=3, D=64),
            glu_row(torch, dev, rng, "sparce_glu_mlp_fused tp 3 shard decode",
                    M=ENGINE["slots"], K=576, F_=512, N=576, act="silu")]
    x, wi, wo, _, _ = relu_decode_operands(torch, dev)
    x = x[: ENGINE["slots"] // 2].contiguous()  # rows 0 and 2 of 4 dead
    M, K = x.shape
    F_, N = wo.shape
    bf = SPARCE_BLOCKS["block_k"]
    kw = dict(block_m=1, block_f=bf)
    _, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
    live = int((bits == 0).sum())
    live_stripes = int((bits == 0).any(dim=0).sum())
    rows.append(("sparce_mlp_fused dp 2 shard decode (4 rows)",
                 lambda: sm.sparce_mlp_fused(x, wi, wo, **kw),
                 lambda: sm.sparce_mlp_fused_plain(x, wi, wo, **kw),
                 lambda: torch.relu(x @ wi) @ wo, MLP_KERNELS,
                 2 * (x.numel() + wi.numel() + live_stripes * bf * N
                      + M * N) + 4 * bits.numel(),
                 2 * M * K * F_ + live * 2 * bf * N, 200))
    return rows


# ------------------------------------------------- phase 12: training
def value_and_grads(torch, cfg, params, batch):
    """(loss, aux metrics, [grad of each param leaf]) of ``loss_fn``."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.modules import iter_leaves
    for p in iter_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    total, metrics = model_lib.loss_fn(params, cfg, batch)
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in iter_leaves(params)]
    for p in iter_leaves(params):
        p.grad = None
        p.requires_grad_(False)
    return total.detach(), grads


def train_config(act, sparsity, **fields):
    from repro_torch.core.sparse_ops import SparsityConfig
    return dataclasses.replace(arch_config(), mlp_act=act,
                               sparsity=SparsityConfig(**sparsity), **fields)


# (label, MLP activation, sparsity, the kernel the run must launch, its
# launches per layer and step): the GLU's down-projection through the
# gated GEMM in FP, BP and WG; the relu MLP's fused forward; dense.
TRAIN_RUNS = (
    ("glu kernel", "silu", dict(enabled=True, mode="kernel"),
     "sparce_gemm_gated", 3),
    ("relu fused", "relu", dict(enabled=True, mode="fused"),
     "sparce_mlp_fused", 1),
    ("dense", "silu", dict(enabled=False), None, 0),
)


def train_data(seed=0, vocab=None, seq=None):
    """Step-keyed batches of ``TRAIN``'s shape (``seq`` tokens a row, if
    given) from the synthetic corpus over ``vocab`` token ids
    (``TRAIN["vocab"]`` by default)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    corpus = SyntheticCorpus(vocab or TRAIN["vocab"],
                             DataConfig(seed=seed, noise=0.05))
    step = 0
    while True:
        yield {"tokens": corpus.batch(step, TRAIN["batch"],
                                      seq or TRAIN["seq"])}
        step += 1


def run_training(torch, dev):
    """``Trainer.run`` on smollm-135m at full width (30 layers, bf16), 8
    sequences of 512 tokens (ids below ``TRAIN["vocab"]``), 20 steps,
    once per ``TRAIN_RUNS`` entry:
    ms per step, tokens/s, peak memory, the loss at first and last; the
    last 5 steps' mean loss below the first 5's and within
    ``LOSS_OVER_LN_VOCAB`` of ln V (what a model that has learned which
    ids occur reaches; the tokens are uniform over V ids); every weight
    matrix of every layer moved from its init; the run's kernel
    launches exactly its per-layer count x layers x steps, no other
    kernel. Returns {label: launches}."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model as model_lib
    from repro_torch.models.modules import iter_leaves
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    shape = ShapeConfig("chip_smoke", TRAIN["seq"], TRAIN["batch"], "train")
    steps, out = TRAIN["steps"], {}
    floor = math.log(TRAIN["vocab"])
    for label, act, sp, kernel, per_layer in TRAIN_RUNS:
        cfg = train_config(act, sp)
        tr = Trainer(cfg, shape, AdamW(lr=1e-3),
                     TrainConfig(steps=steps, log_every=1,
                                 seed=TRAIN["seed"]), device=dev)
        init = [p.clone() for p in iter_leaves(model_lib.init_params(
            cfg, seed=TRAIN["seed"], device=dev)) if p.dim() >= 2]
        data = train_data()
        wrappers = counters()
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "tall_launches"):
                fn.tall_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tr.run(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        tall = {name: fn.tall_launches for name, fn in wrappers.items()
                if getattr(fn, "tall_launches", 0)}
        out[label] = launches
        TALL_LAUNCHES[label] = tall
        hist = [h for h in res["history"] if "loss" in h]
        losses = np.array([h["loss"] for h in hist])
        dts = np.array([h["dt"] for h in hist])
        if len(hist) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"{label}: history {losses}")
        want = {} if kernel is None else {
            kernel: per_layer * cfg.num_layers * steps}
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        # At 8 x 512 rows in bf16 every launch takes the tall path.
        if tall != got:
            raise AssertionError(f"{label}: tall-path launches {tall}, "
                                 f"expected {got}")
        first, last = losses[:5].mean(), losses[-5:].mean()
        if not last < first:
            raise AssertionError(f"{label}: mean loss of the last 5 steps "
                                 f"{last:.4f} not below the first 5's "
                                 f"{first:.4f}")
        if not last < floor + LOSS_OVER_LN_VOCAB:
            raise AssertionError(f"{label}: mean loss of the last 5 steps "
                                 f"{last:.4f} not within "
                                 f"{LOSS_OVER_LN_VOCAB} of ln V {floor:.4f}")
        mats = [p for p in iter_leaves(res["params"]) if p.dim() >= 2]
        still = sum(torch.equal(a, b) for a, b in zip(mats, init))
        if len(mats) != len(init) or still:
            raise AssertionError(f"{label}: {still} of {len(mats)} weight "
                                 "matrices never moved from their init")
        n_mats = len(mats)
        del init, mats
        steady = dts[1:].mean()
        tokens = TRAIN["batch"] * TRAIN["seq"]
        log(f"  train {label}: {steps} steps in {wall:.2f}s wall (init "
            f"included); step 0 {1e3 * dts[0]:.1f} ms, steps 1-{steps - 1} "
            f"{1e3 * steady:.2f} ms per step ({tokens / steady:.0f} "
            f"tokens/s); peak device memory {peak_gib(torch):.2f} GiB")
        log(f"  train {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(mean of the first 5 {first:.4f}, of the last 5 {last:.4f}; "
            f"ln V {floor:.4f}); every one of {n_mats} weight "
            f"matrices moved; launches {got}, on the tall path {tall} -> ok")
        if kernel == "sparce_gemm_gated":  # the slice's kernel path
            profile_train(torch, tr, res, label, steady)
        del tr, res
        torch.cuda.empty_cache()
    return out


# The GLU kernel run's figures before the tall path (PERF.md section 5,
# PRs 22-29): the gated GEMM's device ms a step and the step's ms.
TRAIN_GEMM_MS_BEFORE = 22.0
TRAIN_STEP_MS_BEFORE = (240, 419)
# Tall-path launches of each phase-12 run, by kernel (the kernels line).
TALL_LAUNCHES = {}


def profile_train(torch, tr, res, label, steady, steps=2):
    """Two more steps of a finished run under the profiler, device
    activity only (tracing the host's ops too took ~20 s a window; the
    profiler's overhead still lengthens the wall time, so the busy share
    printed is a lower bound); the gated GEMM's device ms a step
    (``GEMM_KERNELS``) and the run's ms a step beside the figures before
    the tall path."""
    from torch.profiler import ProfilerActivity, profile
    params, state = res["params"], res["opt_state"]
    data = train_data(seed=1)
    batches = [tr.to_device(next(data)) for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            params, state, m = tr.step_fn(params, state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_busy(torch, prof, wall, f"train {label} profiler ({steps} steps)")
    gemm_us = sum(_dev_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(n in e.key for n in GEMM_KERNELS))
    lo, hi = TRAIN_STEP_MS_BEFORE
    log(f"  train {label}: the gated GEMM's device time "
        f"{gemm_us / 1e3 / steps:.3f} ms a step (before the tall path "
        f"{TRAIN_GEMM_MS_BEFORE}); the run's steps 1-{TRAIN['steps'] - 1} "
        f"{1e3 * steady:.2f} ms a step (before {lo}-{hi}; the step is "
        "host-bound, so the GEMM's gain moves it by at most its share)")


def train_batch(torch, cfg, where, seed):
    """A 2 x 256-token batch of the synthetic corpus with the last 64
    positions out of the loss (their error tiles are all zero: the BP
    gate skips them)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch_iterator
    b = next(make_batch_iterator(cfg, ShapeConfig("f32", 256, 2, "train"),
                                 DataConfig(seed=seed)))
    mask = np.ones((2, 256), np.float32)
    mask[:, -64:] = 0.0
    b["loss_mask"] = mask
    return {k: torch.from_numpy(v).to(where) for k, v in b.items()}


def check_train_step_f32(torch, dev):
    """One f32 training step of smollm-135m at full width cut to 2 layers
    (the GLU's gated GEMM in FP, BP and WG), kernels on the card against
    plain versions on the CPU: the loss, every gradient, the optimizer's
    moments, the update wherever the gradient is not near zero (Adam's
    first update is about the gradient's sign there), and the loss
    after it."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.modules import iter_leaves
    from repro_torch.optim.adamw import AdamW
    cfg = train_config("silu", dict(enabled=True, mode="kernel"),
                       num_layers=2, dtype="float32")
    params = model_lib.init_params(cfg, seed=3, device=dev)
    cpu = torch.device("cpu")
    opt, lr = AdamW(lr=1e-3), 1e-3
    res = []
    for where, p in ((dev, params), (cpu, to_device(params, cpu))):
        sg = counters()["sparce_gemm_gated"]
        sg.launches = 0
        batch = train_batch(torch, cfg, where, seed=1)
        loss, grads = value_and_grads(torch, cfg, p, batch)
        new, state, _ = opt.update(grads_tree(p, grads), opt.init(p), p)
        loss2, _ = value_and_grads(torch, cfg, new, batch)
        res.append(dict(loss=float(loss), loss2=float(loss2),
                        grads=[g.cpu() for g in grads],
                        mu=[m.cpu() for m in iter_leaves(state.mu)],
                        nu=[v.cpu() for v in iter_leaves(state.nu)],
                        step=[(a - b).cpu() for a, b in zip(
                            iter_leaves(new), iter_leaves(p))],
                        launches=sg.launches))
    card, host = res
    why = ("2 layers of f32 sums in another order (split-TF32 in the "
           "gated GEMM)")
    if card["launches"] != 3 * 2 * 2:
        raise AssertionError(f"gated GEMM launched {card['launches']} times "
                             "on the card, expected 12 (3 a layer, 2 passes)")
    for key in ("loss", "loss2"):
        err = abs(card[key] - host[key]) / abs(host[key])
        log(f"  f32 step: {key} card {card[key]:.6f} cpu {host[key]:.6f} "
            f"(rel err {err:.2e}, limit 1e-5: {why})")
        if err > 1e-5:
            raise AssertionError(f"f32 step: {key} differs")
    worst = {}
    for key in ("grads", "mu", "nu"):
        for i, (a, b) in enumerate(zip(card[key], host[key])):
            scale = float(b.abs().max()) or 1.0
            err = float((a - b).abs().max()) / scale
            worst[key] = max(worst.get(key, 0.0), err)
            if err > 1e-3:
                raise AssertionError(f"f32 step: {key} leaf {i} differs "
                                     f"(max err {err:.2e} of its scale)")
    for i, (a, b, g) in enumerate(zip(card["step"], host["step"],
                                      host["grads"])):
        sure = g.abs() >= 1e-3 * max(float(g.abs().max()), 1e-30)
        err = float((a - b)[sure].abs().max()) if bool(sure.any()) else 0.0
        worst["update"] = max(worst.get("update", 0.0), err / lr)
        if err > 1e-3 * lr:
            raise AssertionError(f"f32 step: update of leaf {i} differs "
                                 f"by {err:.2e}")
    log(f"  f32 step: every gradient, moment and update within 1e-3 of its "
        f"scale (worst {worst}; {why}); gated GEMM launched "
        f"{card['launches']} times on the card -> ok")


def grads_tree(params, grads):
    """A list of leaf gradients as a tree shaped like ``params``."""
    from repro_torch.models.modules import tree_map
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


def check_restart(torch, dev):
    """The Trainer's checkpoint and in-loop restart on the card: the f32
    2-layer config, 8 steps with checkpoints (async) every 4, a
    RuntimeError injected at step 6; the data keyed by step, so after
    the restore from step 4 the losses must equal an uninterrupted
    run's, within 1e-4 (the embedding's backward adds with atomics, in an
    order the card picks)."""
    import shutil
    import tempfile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch_iterator
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = train_config("silu", dict(enabled=True, mode="kernel"),
                       num_layers=2, dtype="float32")
    shape = ShapeConfig("restart", 256, 2, "train")
    it = make_batch_iterator(cfg, shape, DataConfig(seed=2))
    batches = [next(it) for _ in range(8)]

    class Keyed:
        def __init__(self):
            self.pos = 0

        def __next__(self):
            self.pos += 1
            return batches[self.pos - 1]

    def losses(res):
        return [h["loss"] for h in res["history"] if "loss" in h]

    whole = Trainer(cfg, shape, AdamW(lr=1e-3), TrainConfig(
        steps=8, log_every=1, seed=3), device=dev).run(Keyed())
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        data, crashed = Keyed(), []

        def fault(step):
            if step == 6 and not crashed:
                crashed.append(step)
                data.pos = 4  # the restart re-reads from the restored step
                raise RuntimeError("injected fault")
        res = Trainer(cfg, shape, AdamW(lr=1e-3), TrainConfig(
            steps=8, log_every=1, ckpt_every=4, ckpt_dir=d, async_ckpt=True,
            seed=3), device=dev).run(data, fault_hook=fault)
        saved = sorted(os.listdir(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    events = [h for h in res["history"] if h.get("event") == "restart"]
    a, b = losses(whole), losses(res)
    if len(events) != 1 or res["final_step"] != 8 or len(b) != 6 + 4:
        raise AssertionError(f"restart: events {events}, losses {b}")
    want = np.array(a[:6] + a[4:])
    err = float(np.max(np.abs(np.array(b) - want) / np.abs(want)))
    if err > 1e-4:
        raise AssertionError(f"restart: losses {b} vs uninterrupted {a}")
    log(f"  restart: checkpoints {saved}; fault at step 6, restored step "
        f"4; the 10 logged losses equal the uninterrupted run's (steps 0-5, "
        f"4-7) within {err:.2e} (limit 1e-4) -> ok")


def deepseek_config():
    """DeepSeek-V3 at its published widths, cut to 4 layers: the 3 dense
    MLA + GLU layers (first_k_dense as published) and 1 MLA + MoE layer."""
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


def profile_engine(torch, cfg, params, sc, dev, label, trace=ENGINE):
    """Device time by kernel over a short engine run under the profiler,
    device activity only (the host's ops too took many times the run to
    read back; the profiler's overhead still lengthens the wall time, so
    the busy share printed is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.server import Server
    srv = Server(cfg, params, sc, device=dev)
    reqs = engine_requests(cfg, trace["slots"], seed=7, trace=trace)
    for r in reqs:
        r.max_new = 8
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log_busy(torch, prof, wall, f"{label} profiler ("
             f"{int(srv.metrics.ticks)} ticks, {int(srv.metrics.admitted)} "
             "prefills)")


def log_busy(torch, prof, wall, what):
    """The device's busy share of a profiled window and its ten largest
    device items by total time."""
    # Device-side events only (kernels, memcpy/memset); the CPU-side
    # aten ops that launched them would count the same time again.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _dev_us(e) > 0]
    total_us = sum(_dev_us(e) for e in events)
    if not events:
        log("  profiler: no device time recorded")
        return
    log(f"  {what}: device busy {total_us / 1e3:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall ({total_us / 1e4 / wall:.1f}%)")
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


def relu_bwd_library(torch, x, g, br, bc):
    """relu_bwd_bitmap's yardstick at any shape: ``torch.where`` and a
    tile-any of ``gx != 0`` over (br, bc) tiles, the edge padded with
    False."""
    R, C = x.shape
    gr, gc = -(-R // br), -(-C // bc)

    def library():
        gx = torch.where(x > 0, g, torch.zeros_like(g))
        live = torch.nn.functional.pad(gx != 0, (0, gc * bc - C,
                                                 0, gr * br - R))
        return gx, ~live.view(gr, br, gc, bc).any(3).any(1)

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
    on the same unpadded inputs: bits equal, gx equal bit for bit (NaN in
    the same places). Returns the largest |gx - plain| over the non-NaN
    positions."""
    from repro_torch.kernels import relu_bitmap as rb
    err, dead = 0.0, {}
    for (bench, name), (y, g, (br, bc), gx, ebits) in bwd.items():
        r, c = y.shape
        gx0, bits0 = rb.relu_bwd_bitmap_plain(y, g, block_r=br, block_c=bc)
        what = f"relu_bwd_with_bitmap {bench}/{name} {(r, c)} tile {(br, bc)}"
        if not (torch.equal(ebits.bits, bits0) and same_bits(torch, gx, gx0)):
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
    (8, 1536), tile (1, 128); x the pre-activation, g normal. Then logged
    by both witnesses beside the library call's: a 256-row prefill at the
    same tile, and phase 7's largest operand, alexnet conv1's output
    (3025 x 96, f32) at its plan's tile (256, 128), unpadded."""
    from repro_torch.kernels import relu_bitmap as rb
    _, _, _, h, _ = relu_decode_operands(torch, dev)
    g = torch.randn(h.shape, device=dev).to(h.dtype)
    bc = SPARCE_BLOCKS["block_k"]
    M, F_ = h.shape
    ms = cuda_time_ms(lambda: rb.relu_bwd_bitmap(h, g, block_r=1,
                                                 block_c=bc), 200)
    plain_ms = cuda_time_ms(lambda: rb.relu_bwd_bitmap_plain(
        h, g, block_r=1, block_c=bc), 200)
    library = relu_bwd_library(torch, h, g, 1, bc)
    lib_ms = cuda_time_ms(library, 200)
    log_device_witnesses(
        "relu_bwd_bitmap decode", ms,
        lambda: rb.relu_bwd_bitmap(h, g, block_r=1, block_c=bc), lib_ms,
        library, RELU_BWD_KERNELS)
    gen = torch.Generator(device=dev).manual_seed(15)
    for label, shape, dtype, (br, bcc) in (
            ("prefill 256 rows", (256, F_), h.dtype, (1, bc)),
            ("alexnet conv1 output", (3025, 96), torch.float32, (256, 128))):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        gg = torch.randn(shape, generator=gen, device=dev).to(dtype)
        run = lambda: rb.relu_bwd_bitmap(x, gg, block_r=br,  # noqa: E731
                                         block_c=bcc)
        lib = relu_bwd_library(torch, x, gg, br, bcc)
        grid = rb.relu_bitmap_grid(*shape, br, bcc, dtype)
        log(f"  relu_bwd_bitmap launch at {shape} tile ({br},{bcc}): "
            f"{grid['ctas']} CTAs of up to {grid['tiles_per_cta']} tiles")
        # Every kernel of the call: a split tile's call fills the bits.
        log_device_witnesses(f"relu_bwd_bitmap {label}",
                             cuda_time_ms(run, 200), run,
                             cuda_time_ms(lib, 200), lib, None)
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


# ------------------------------------------ phase 14: training on a mesh
# Every rank a gloo process on card 0, as in phase 13. (mesh, jobs):
# "f32" (and "f32 zero1", its moments cut over 'data') MESH_F32_STEPS
# f32 steps of smollm-135m at full width (30 layers, phase 12's 8 x 512
# tokens) held step by step to a single rank's: the later steps' loss and
# grad norm read the params the earlier updates left; "glu kernel" and "relu
# fused zero1" phase 12's bf16 runs for TRAIN_MESH_STEPS steps (the GLU's
# gated GEMM FP/BP/WG at the tp-3 shard's F 512; the fused relu MLP at a
# dp-2 shard's 2048 rows, moments cut over 'data'); "ep" qwen2-moe-a2.7b's
# MoE layer and two training steps, 30 of its 60 experts a rank.
TRAIN_MESH_TIMEOUT_S = 120.0
TRAIN_MESH_DEADLINE_S = 600.0
# 2 steps (3 before phase 16 took its share of the script's time): the
# second is the steady one.
TRAIN_MESH_STEPS = 2
MESH_F32_STEPS = 2
TRAIN_MESH_RUNS = (
    ((1, 3), ("f32", "glu kernel")),
    ((2, 1), ("f32 zero1", "relu fused zero1")),
    ((1, 2), ("ep",)),
)
# qwen2-moe-a2.7b at its published widths (d 2048, 60 experts of d_expert
# 1408, top 4, 4 shared), cut from 24 to 2 layers; the layer check's
# tokens, and the training steps' batch.
EP_ARCH = "qwen2-moe-a2.7b"
EP_DEPTH = dict(num_layers=2)
EP_TOKENS = 16
EP_TRAIN = dict(batch=2, seq=256, steps=2)
# The reference's sharded-step tolerances (tests/test_distributed.py).
MESH_LOSS_RTOL, MESH_GNORM_RTOL = 1e-4, 1e-3


def vocab_cut(cfg, params):
    """Whether this rank stores the embedding cut over its vocab: the
    plan then runs the embedding, head and loss on its vocab slice."""
    return params["embed"].shape[-2] < cfg.vocab_size


def gather_note(c, steps, cut):
    """All-gather bytes and calls a step of the collectives stats ``c``
    taken over ``steps`` steps, and whether the vocab was cut."""
    return (f"all-gather {c['all-gather'] / steps:.0f} B / "
            f"{c['counts']['all-gather'] / steps:g} calls / "
            f"{c['seconds']['all-gather'] / steps:.3f}s a step, vocab "
            + ("cut over 'model'" if cut else "whole"))


def mesh_step_f32(torch, dev, mesh, zero1=False):
    """MESH_F32_STEPS f32 training steps of smollm-135m at full width on
    ``dev`` (on this rank of ``mesh``, or alone) on phase 12's batches:
    each step's global loss and grad norm, and the seconds per step; on
    a mesh also the steps' collectives and whether the vocab is cut."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import collectives
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = dataclasses.replace(arch_config(), dtype="float32")
    shape = ShapeConfig("chip_smoke", TRAIN["seq"], TRAIN["batch"], "train")
    tr = Trainer(cfg, shape, AdamW(lr=1e-3), TrainConfig(
        steps=MESH_F32_STEPS, seed=TRAIN["seed"], zero1=zero1), mesh=mesh,
        device=dev)
    params, state = tr.init_state(TRAIN["seed"])
    data = train_data()
    out = dict(losses=[], grad_norms=[], step_s=[])
    if mesh is not None:
        out["vocab_cut"] = vocab_cut(cfg, params)
        collectives.reset_stats()
    for _ in range(MESH_F32_STEPS):
        batch = tr.to_device(next(data))
        t0 = time.perf_counter()
        params, state, m = tr.step_fn(params, state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["step_s"].append(time.perf_counter() - t0)
    if mesh is not None:
        out["collectives"] = collectives.stats()
    return out


def mesh_train_run(torch, dev, mesh, job, seq=None):
    """Phase 12's bf16 run ``job`` ("glu kernel", "relu fused zero1";
    "glu kernel sp" with ``seq_shard``) for TRAIN_MESH_STEPS steps on
    this rank, ``seq`` tokens a row (``TRAIN["seq"]`` by default):
    losses, ms per step, the collectives, peak memory, the moments' and
    params' bytes and the kernels' launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.modules import iter_leaves
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import collectives
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    label = job.replace(" zero1", "").replace(" sp", "")
    _, act, sp, kernel, per_layer = next(r for r in TRAIN_RUNS
                                         if r[0] == label)
    cfg = train_config(act, sp, seq_shard=job.endswith(" sp"))
    seq = seq or TRAIN["seq"]
    shape = ShapeConfig("chip_smoke", seq, TRAIN["batch"], "train")
    with drawn_on_card(torch):  # every rank draws the same whole params
        tr = Trainer(cfg, shape, AdamW(lr=1e-3), TrainConfig(
            steps=TRAIN_MESH_STEPS, log_every=1, seed=TRAIN["seed"],
            zero1=job.endswith("zero1")), mesh=mesh, device=dev)
        wrappers = counters()
        for fn in wrappers.values():
            fn.launches = 0
        collectives.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        res = tr.run(train_data(seq=seq))
    torch.cuda.synchronize()
    hist = [h for h in res["history"] if "loss" in h]
    state = res["opt_state"]
    return dict(
        losses=[h["loss"] for h in hist], dts=[h["dt"] for h in hist],
        launches={k: fn.launches for k, fn in wrappers.items() if
                  fn.launches},
        expect={kernel: per_layer * cfg.num_layers * TRAIN_MESH_STEPS},
        tokens=TRAIN["batch"] * seq,
        collectives=collectives.stats(), peak_gib=peak_gib(torch),
        vocab_cut=vocab_cut(cfg, res["params"]),
        moment_bytes=sum(4 * t.numel() for t in iter_leaves(
            (state.mu, state.nu))),
        param_bytes=sum(t.numel() * t.element_size()
                        for t in iter_leaves(res["params"])))


def ep_config(dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(EP_ARCH), dtype=dtype,
                               **EP_DEPTH)


def check_ep_layer(torch, dev, mesh):
    """qwen2-moe-a2.7b's MoE layer (f32) on this rank of ``mesh``
    through the expert-parallel path, EP_TOKENS tokens: y, the aux loss
    and the gradients of sum(y**2) + aux gathered; on rank 0 also the
    single-rank global path on the whole layer, which they must equal
    within f32 sums in another order, with no assignment dropped."""
    from repro_torch.checkpoint.manager import gather_whole
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.modules import iter_leaves
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    cfg = ep_config("float32")
    rng = np.random.default_rng(14)
    full = {"moe": moe_lib.moe_init(rng, cfg, torch.float32, dev)}
    x = torch.from_numpy(rng.standard_normal(
        (1, EP_TOKENS, cfg.d_model), dtype=np.float32) * 0.3).to(dev)
    specs = shd.param_specs(full, mesh)
    local = shd.cut_tree(full, specs, mesh, mesh.rank)
    leaves = list(iter_leaves(local))
    xl = x.clone()
    for p in leaves + [xl]:
        p.requires_grad_(True)
    plan = shd.TrainPlan(mesh, cfg, specs, local, batch_axes=("data",))
    if plan.moe_groups(cfg) != ("ep", mesh.shape["model"]):
        raise AssertionError(f"EP not taken: {plan.moe_groups(cfg)}")
    with shd.use_plan(plan):
        y, aux, ss = moe_lib.moe_forward(local["moe"], xl, cfg)
        (torch.sum(y * y) + aux).backward()
    pspecs = list(shd.iter_leaves_specs(specs))
    grads = gather_whole([p.grad for p in leaves], pspecs, mesh)
    E, K, T = cfg.moe.num_experts, cfg.moe.top_k, EP_TOKENS
    C = moe_lib.capacity(T, cfg)
    kept = round((1.0 - float(ss)) * E * C)
    expert_bytes = sum(local["moe"][k].numel() * 4
                       for k in ("w_in", "w_gate", "w_out"))
    out = dict(kept=kept, expert_bytes=expert_bytes,
               local_experts=int(local["moe"]["w_in"].shape[0]))
    if mesh.rank != 0:
        return out
    for p in iter_leaves(full):
        p.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    yg, auxg, ssg = moe_lib._moe_forward_global(full["moe"], xg, cfg)
    (torch.sum(yg * yg) + auxg).backward()
    kept_g = round((1.0 - float(ssg)) * E * C)
    if kept != T * K or kept_g != T * K:
        raise AssertionError(f"EP layer: assignments kept {kept} (EP), "
                             f"{kept_g} (global) of {T * K}")
    errs = {"y": (y, yg), "x grad": (xl.grad, xg.grad)}
    errs.update({f"grad {i}": (a, b.grad) for i, (a, b) in enumerate(
        zip(grads, iter_leaves(full)))})
    worst = {}
    for name, (a, b) in errs.items():
        a, b = a.detach(), b.detach()
        scale = float(b.abs().max()) or 1.0
        err = float((a - b).abs().max()) / scale
        worst[name] = err
        if err > 1e-4:
            raise AssertionError(f"EP layer: {name} differs from the global "
                                 f"path by {err:.2e} of its scale")
    aerr = abs(float(aux) - float(auxg)) / abs(float(auxg))
    if aerr > 1e-5:
        raise AssertionError(f"EP layer: aux {float(aux)} vs {float(auxg)}")
    out.update(worst=max(worst.values()), aux_err=aerr,
               collectives=collectives.stats())
    return out


def run_ep_training(torch, dev, mesh):
    """EP_TRAIN's steps of the 2-layer bf16 qwen2-moe-a2.7b on this rank
    (every MoE layer expert-parallel): losses, ms per step, peak memory,
    the rank's expert bytes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_batch_iterator
    from repro_torch.models.modules import iter_leaves
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import collectives
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = ep_config("bfloat16")
    shape = ShapeConfig("ep", EP_TRAIN["seq"], EP_TRAIN["batch"], "train")
    with drawn_on_card(torch):  # every rank draws the same whole params
        tr = Trainer(cfg, shape, AdamW(lr=1e-3), TrainConfig(
            steps=EP_TRAIN["steps"], log_every=1), mesh=mesh, device=dev)
        collectives.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        res = tr.run(make_batch_iterator(cfg, shape, DataConfig(seed=0)))
    torch.cuda.synchronize()
    hist = [h for h in res["history"] if "loss" in h]
    experts = [p for key in ("stack",) for layer in res["params"][key]
               for k, p in layer["moe"].items() if k in ("w_in", "w_gate",
                                                        "w_out")]
    return dict(losses=[h["loss"] for h in hist],
                dts=[h["dt"] for h in hist], peak_gib=peak_gib(torch),
                expert_bytes=sum(p.numel() * p.element_size()
                                 for p in experts),
                param_bytes=sum(p.numel() * p.element_size()
                                for p in iter_leaves(res["params"])),
                collectives=collectives.stats(),
                vocab_cut=vocab_cut(cfg, res["params"]))


def train_mesh_rank(mesh, jobs, device):
    """One rank of a phase 14 mesh: each job in turn, with its seconds."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        if job.startswith("f32"):
            r = mesh_step_f32(torch, dev, mesh, zero1=job.endswith("zero1"))
        elif job == "ep":
            r = dict(layer=check_ep_layer(torch, dev, mesh))
            torch.cuda.empty_cache()
            r["train"] = run_ep_training(torch, dev, mesh)
        else:
            r = mesh_train_run(torch, dev, mesh, job)
        r["seconds"] = time.perf_counter() - t0
        out.append(r)
        torch.cuda.empty_cache()
    return out


def log_mesh_train(label, outs, i):
    """Phase 14's bf16 run ``label`` on every rank: the same losses, the
    launches exactly per layer x layers x steps, and per rank ms per
    step, tokens/s, collectives, peak memory and bytes."""
    r0 = outs[0][i]
    tokens = r0["tokens"]
    moments = sum(o[i]["moment_bytes"] for o in outs)
    for r, o in enumerate(outs):
        got = o[i]
        if not np.isfinite(got["losses"]).all() or len(got["losses"]) != (
                TRAIN_MESH_STEPS):
            raise AssertionError(f"{label} rank {r}: losses {got['losses']}")
        if got["losses"] != r0["losses"]:
            raise AssertionError(f"{label}: rank {r}'s losses "
                                 f"{got['losses']} != rank 0's")
        if got["launches"] != got["expect"]:
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{got['launches']}, expected "
                                 f"{got['expect']}")
        steady = float(np.mean(got["dts"][1:]))
        c = got["collectives"]
        secs = sum(c["seconds"].values())
        log(f"  {label} rank {r}: step 0 {1e3 * got['dts'][0]:.1f} ms, "
            f"steps 1-{TRAIN_MESH_STEPS - 1} {1e3 * steady:.2f} ms per "
            f"step ({tokens / steady:.0f} tokens/s of the global batch); "
            f"peak device memory {got['peak_gib']:.2f} GiB; params "
            f"{got['param_bytes']} B, moments {got['moment_bytes']} B "
            f"({got['moment_bytes'] / moments:.3f} of the ranks' "
            f"{moments} B); launches {got['launches']} (= per layer x "
            f"layers x "
            f"{TRAIN_MESH_STEPS} steps) -> ok")
        log(f"  {label} rank {r} collectives: "
            + ", ".join(f"{k} {c['counts'][k]} calls / {c[k]} B / "
                        f"{c['seconds'][k]:.3f}s" for k in c["counts"]
                        if c["counts"][k])
            + f"; {secs:.3f}s in all, "
              f"{1e3 * secs / TRAIN_MESH_STEPS:.1f} ms per step; "
            + gather_note(c, TRAIN_MESH_STEPS, got["vocab_cut"]))
    log(f"  {label}: losses {['%.4f' % v for v in r0['losses']]} equal on "
        f"every rank")


def check_mesh_f32(label, single, ranks):
    """Every rank's loss and grad norm at every step of an f32 mesh run
    against the single rank's, at the reference's tolerances; logs the
    largest relative error over the ranks at each step."""
    for k in range(MESH_F32_STEPS):
        le = ge = 0.0
        for r, got in enumerate(ranks):
            loss, gnorm = got["losses"][k], got["grad_norms"][k]
            le = max(le, abs(loss - single["losses"][k])
                     / single["losses"][k])
            ge = max(ge, abs(gnorm - single["grad_norms"][k])
                     / single["grad_norms"][k])
            if le > MESH_LOSS_RTOL or ge > MESH_GNORM_RTOL:
                raise AssertionError(
                    f"{label} rank {r} step {k}: loss {loss} grad norm "
                    f"{gnorm} vs single rank {single['losses'][k]} "
                    f"{single['grad_norms'][k]}")
        log(f"  {label} step {k}: loss {ranks[0]['losses'][k]:.6f}, grad "
            f"norm {ranks[0]['grad_norms'][k]:.6f}; largest rel err over "
            f"the {len(ranks)} ranks: loss {le:.2e} (limit "
            f"{MESH_LOSS_RTOL}), grad norm {ge:.2e} (limit "
            f"{MESH_GNORM_RTOL}); {ranks[0]['step_s'][k]:.3f}s -> ok")
    for r, got in enumerate(ranks):
        log(f"  {label} rank {r}: "
            + gather_note(got["collectives"], MESH_F32_STEPS,
                          got["vocab_cut"]))


def run_train_meshes(torch, dev):
    """Phase 14: the single-rank f32 step, then each mesh of
    TRAIN_MESH_RUNS spawned on card 0 (gloo)."""
    from repro_torch.launch.mesh import spawn_mesh
    single = mesh_step_f32(torch, dev, None)
    for k in range(MESH_F32_STEPS):
        log(f"  f32 single rank step {k}: loss {single['losses'][k]:.6f}, "
            f"grad norm {single['grad_norms'][k]:.6f}, "
            f"{single['step_s'][k]:.3f}s")
    torch.cuda.empty_cache()
    rank_dev = str(dev) if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    for mesh, jobs in TRAIN_MESH_RUNS:
        t0 = time.perf_counter()
        outs = spawn_mesh(train_mesh_rank, mesh, (jobs, rank_dev),
                          device=rank_dev, backend="gloo",
                          timeout_s=TRAIN_MESH_TIMEOUT_S,
                          deadline_s=TRAIN_MESH_DEADLINE_S,
                          axes=("data", "model"))
        log(f"  mesh {mesh}: {mesh[0] * mesh[1]} ranks on card 0 (gloo), "
            f"spawn to exit {time.perf_counter() - t0:.1f}s; jobs "
            + ", ".join(f"{j} {outs[0][i]['seconds']:.1f}s"
                        for i, j in enumerate(jobs)))
        for i, job in enumerate(jobs):
            label = f"{job} {mesh}"
            if job.startswith("f32"):
                check_mesh_f32(label, single, [o[i] for o in outs])
            elif job == "ep":
                lay = outs[0][i]["layer"]
                log(f"  {label} layer: {EP_TOKENS} tokens, every one of "
                    f"{lay['kept']} assignments kept on both paths; y, aux "
                    f"and every gradient within {lay['worst']:.2e} of their "
                    f"scale (limit 1e-4; aux {lay['aux_err']:.2e}) of the "
                    f"single-rank global path -> ok")
                for r, o in enumerate(outs):
                    tr = o[i]["train"]
                    if not np.isfinite(tr["losses"]).all():
                        raise AssertionError(f"{label}: {tr['losses']}")
                    c = tr["collectives"]
                    log(f"  {label} rank {r}: {o[i]['layer']['local_experts']}"
                        f" experts a layer, expert bytes {tr['expert_bytes']}"
                        f" (bf16), params {tr['param_bytes']} B; "
                        f"{EP_TRAIN['steps']} steps of {EP_TRAIN['batch']} x "
                        f"{EP_TRAIN['seq']} tokens: losses "
                        f"{['%.4f' % v for v in tr['losses']]}, "
                        + ", ".join(f"{1e3 * d:.1f}" for d in tr["dts"])
                        + f" ms per step; peak {tr['peak_gib']:.2f} GiB; "
                        + ", ".join(f"{k} {c['counts'][k]} / {c[k]} B / "
                                    f"{c['seconds'][k]:.3f}s"
                                    for k in c["counts"] if c["counts"][k])
                        + "; " + gather_note(c, EP_TRAIN["steps"],
                                             tr["vocab_cut"]))
            else:
                log_mesh_train(label, outs, i)


def phase14_rows(torch, dev):
    """The training kernels at a mesh shard's shapes: the fused relu MLP
    at a dp-2 shard's 2048 rows, the gated GEMM at the tp-3 shard's FP,
    BP and WG (F 512; 30% of the gated operand's tiles zero)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_mlp as sm
    rng = np.random.default_rng(9)
    M, K, F_, N = TRAIN["batch"] * TRAIN["seq"] // 2, 576, 1536, 576
    x = bf16_normal(torch, dev, rng, M, K)
    wi = bf16_normal(torch, dev, rng, K, F_, scale=K ** -0.5)
    wo = bf16_normal(torch, dev, rng, F_, N, scale=F_ ** -0.5)
    mkw = dict(block_m=64, block_f=128, act="relu")
    rows = [("sparce_mlp_fused training forward dp 2 shard (2048 rows)",
             lambda: kops.sparce_mlp_fused(x, wi, wo, **mkw),
             lambda: sm.sparce_mlp_fused_plain(x, wi, wo, **mkw),
             lambda: torch.relu(x @ wi) @ wo, MLP_KERNELS,
             (M * K + K * F_ + F_ * N + M * N) * 2,
             2 * M * K * F_ + 2 * M * F_ * N, 100)]
    return rows + train_gemm_rows(torch, dev, 10, "tp 3 shard", F_=TP3_F)


def phase16_rows(torch, dev):
    """The fused relu MLP at phase 16 (b)'s shapes: the tp-3 shard's F
    512 over 8 x SP_SEQ gathered rows, f32 (split-TF32) as (b) runs it."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparce_mlp as sm
    rng = np.random.default_rng(12)
    M, K, F_, N = TRAIN["batch"] * SP_SEQ, 576, TP3_F, 576

    def normal(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev)
    x = normal(M, K)
    wi, wo = normal(K, F_, scale=K ** -0.5), normal(F_, N, scale=F_ ** -0.5)
    mkw = dict(block_m=64, block_f=128, act="relu")
    return [(f"sparce_mlp_fused f32 training forward sp tp 3 shard ({M} "
             f"rows, F {F_})",
             lambda: kops.sparce_mlp_fused(x, wi, wo, **mkw),
             lambda: sm.sparce_mlp_fused_plain(x, wi, wo, **mkw),
             lambda: torch.relu(x @ wi) @ wo, MLP_KERNELS,
             (M * K + K * F_ + F_ * N + M * N) * 4,
             2 * M * K * F_ + 2 * M * F_ * N, 100)]


def train_gemm_rows(torch, dev, seed, where, **shape):
    """Rows of the bf16 gated GEMM at a training step's FP, BP and WG
    (``train_gemm_operands`` at ``shape``; 30% of the gated operand's
    tiles zero)."""
    from repro_torch.core import sprf
    from repro_torch.kernels import sparce_gemm as sg
    a, w, gr, (bm, bk, bn) = train_gemm_operands(torch, torch.bfloat16,
                                                 seed, **shape)
    a, w, gr = a.to(dev), w.to(dev), gr.to(dev)
    abits = sprf.compute_bitmap(a, (bm, bk)).bits
    gbits = sprf.compute_bitmap(gr, (bm, bn)).bits
    rows = []
    for label, lhs, rhs, bits, (pm, pk, pn) in (
            ("FP", a, w, abits, (bm, bk, bn)),
            ("BP", gr, w.T.contiguous(), gbits, (bm, bn, bk)),
            ("WG", a.T.contiguous(), gr, abits.T.contiguous(),
             (bk, bm, bn))):
        kw = dict(block_m=pm, block_k=pk, block_n=pn, gate="lhs")
        live = int(bits.numel() - bits.sum())
        Mx, Kx = lhs.shape
        Nx = rhs.shape[1]
        rows.append((
            f"sparce_gemm_gated training {where} {label} "
            f"{tuple(lhs.shape)} @ {tuple(rhs.shape)}",
            lambda lhs=lhs, rhs=rhs, bits=bits, kw=kw:
                sg.sparce_gemm_gated(lhs, rhs, bits, **kw),
            lambda lhs=lhs, rhs=rhs, bits=bits, kw=kw:
                sg.sparce_gemm_gated_plain(lhs, rhs, bits, **kw),
            lambda lhs=lhs, rhs=rhs: lhs @ rhs, GEMM_KERNELS,
            (live * pm * pk + Kx * Nx + Mx * Nx) * 2 + bits.numel() * 4,
            2 * live * pm * pk * Nx, 100))
    return rows


# ------------------------------- phase 15: pipeline stages, the dry run
# Phase 12's bf16 GLU kernel config (30 layers, the gated GEMM in FP, BP
# and WG) cut into PIPE_STAGES stages of 15 layers over a ("pod",) mesh
# of gloo ranks on card 0, phase 12's 8 x 512 tokens in PIPE["n_micro"]
# micro-batches; PIPE["steps"] timed steps after one warm-up.
PIPE_STAGES = 2
PIPE = dict(n_micro=4, steps=3)
# Rows of one micro-batch, the gated GEMM's M (FP, BP) and WG's reduction.
PIPE_MICRO_ROWS = TRAIN["batch"] // PIPE["n_micro"] * TRAIN["seq"]
PIPE_F32_LAYERS = 4
# The f32 pipeline against one rank: every element of y and of each
# gradient within this share of its tensor's largest magnitude (f32
# products over 2-row micro-batches against the whole 8-row batch).
PIPE_F32_REL = 1e-4
# The bf16 30-layer pipeline's y against one rank's, in the same terms:
# the training GEMMs' bf16 limit (the micro-batches' GEMMs sum in another
# order, and each layer rounds to bf16).
PIPE_BF16_REL = TRAIN_GEMM_REL["bfloat16"][0]
PIPE_TIMEOUT_S = 120.0
PIPE_DEADLINE_S = 300.0
# (arch, shape, two pods): the dry run's cells.
DRYRUN_CELLS = (("smollm-135m", "train_4k", False),
                ("deepseek-v3-671b", "decode_32k", True))


def stack_trees(torch, trees):
    """One tree whose leaves stack ``trees``' leaves on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees(torch, [t[k] for t in trees])
                for k in trees[0]}
    return torch.stack(trees)


def index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def pipe_case(torch, dev, dtype, layers):
    """(cfg, stage params, x, stage_fn) of the phase 15 pipeline: the GLU
    kernel config in ``dtype`` cut to ``layers``, its layers stacked per
    stage (leaves (PIPE_STAGES, layers / PIPE_STAGES, ...)), phase 12's
    first batch embedded, and the stage: ``stack_fwd`` over its
    layers."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer as tfm
    cfg = train_config("silu", dict(enabled=True, mode="kernel"),
                       dtype=dtype, num_layers=layers)
    params = model_lib.init_params(cfg, seed=TRAIN["seed"], device=dev)
    per = layers // PIPE_STAGES
    stacked = stack_trees(torch, [
        stack_trees(torch, params["stack"][s * per:(s + 1) * per])
        for s in range(PIPE_STAGES)])
    tokens = torch.from_numpy(next(train_data())["tokens"]).to(dev)
    x = params["embed"][tokens.long()].detach()

    def stage_fn(p, h):
        pos = torch.arange(h.shape[1], dtype=torch.int32,
                           device=h.device)[None].expand(h.shape[0], -1)
        y, _, _ = tfm.stack_fwd([index_tree(p, i) for i in range(per)], h,
                                pos, cfg, "dense")
        return y
    return cfg, stacked, x, stage_fn


def pipe_leaves(tree):
    from repro_torch.models.modules import iter_leaves
    return list(iter_leaves(tree))


def pipe_steps(torch, run, leaves, steps):
    """``steps`` steps of ``run()`` (a forward returning y) and the
    backward of sum(y**2), after one warm-up; the kernels' launches and
    the collectives counted from 0 over the timed steps alone. Returns
    (ms a step, launches, the last y)."""
    from repro_torch.parallel import collectives
    wrappers = counters()

    def step():
        for p in leaves:
            p.grad = None
        y = run()
        torch.sum(torch.square(y.float())).backward()
        return y
    step()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    if collectives.get_mesh() is not None:
        collectives.reset_stats()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        y = step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    return ms, launches, y


def pipe_sequential(torch, dev, dtype, layers, steps):
    """One rank's run of the same layers on the whole batch: ms a step,
    launches, y and the stacked params' gradients."""
    _, stacked, x, stage_fn = pipe_case(torch, dev, dtype, layers)
    leaves = pipe_leaves(stacked)
    for p in leaves:
        p.requires_grad_(True)

    def run():
        h = x
        for s in range(PIPE_STAGES):
            h = stage_fn(index_tree(stacked, s), h)
        return h
    ms, launches, y = pipe_steps(torch, run, leaves, steps)
    return dict(ms=ms, launches=launches, y=y.detach(),
                grads=[p.grad.detach() for p in leaves])


def pipe_rank(mesh, device):
    """One rank of phase 15's pipeline mesh: the bf16 30-layer run (ms a
    step, launches, collectives, y on the host), then the f32 4-layer one
    (y and the gradients of this rank's stage, on the host)."""
    import torch
    from repro_torch.parallel import collectives
    from repro_torch.parallel.pipeline import pipeline_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    out = {}
    for label, dtype, layers, steps in (
            ("bf16", "bfloat16", arch_config().num_layers, PIPE["steps"]),
            ("f32", "float32", PIPE_F32_LAYERS, 1)):
        _, stacked, x, stage_fn = pipe_case(torch, dev, dtype, layers)
        leaves = pipe_leaves(stacked)
        for p in leaves:
            p.requires_grad_(True)
        ms, launches, y = pipe_steps(torch, lambda: pipeline_forward(
            stage_fn, stacked, x, mesh, axis="pod",
            n_micro=PIPE["n_micro"]), leaves, steps)
        stage = mesh.coord("pod")
        r = dict(ms=ms, launches=launches, collectives=collectives.stats(),
                 stage=stage, peak_gib=peak_gib(torch),
                 y=y.detach().float().cpu().numpy())
        if label == "f32":
            r.update(grads=[p.grad[stage].detach().cpu().numpy()
                            for p in leaves])
        out[label] = r
        del stacked, leaves, x
        torch.cuda.empty_cache()
    return out


def run_pipeline(torch, dev):
    """Phase 15 (a) and (b): one rank's sequential runs, then the
    pipeline mesh spawned on card 0 (gloo); the launches, y and the
    gradients held against the schedule and the single rank."""
    from repro_torch.launch.mesh import spawn_mesh
    L = arch_config().num_layers
    per = L // PIPE_STAGES
    sched = PIPE["n_micro"] + PIPE_STAGES - 1
    single = pipe_sequential(torch, dev, "bfloat16", L, PIPE["steps"])
    torch.cuda.empty_cache()
    ref = pipe_sequential(torch, dev, "float32", PIPE_F32_LAYERS, 1)
    torch.cuda.empty_cache()
    rank_dev = str(dev) if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    outs = spawn_mesh(pipe_rank, (PIPE_STAGES,), (rank_dev,),
                      device=rank_dev, backend="gloo",
                      timeout_s=PIPE_TIMEOUT_S, deadline_s=PIPE_DEADLINE_S,
                      axes=("pod",))
    log(f"  pipeline ({PIPE_STAGES},) over 'pod': {PIPE_STAGES} ranks on "
        f"card 0 (gloo), spawn to exit {time.perf_counter() - t0:.1f}s")
    # (a) the bf16 run: launches by the schedule, y and ms against one
    # rank's.
    want = {"sparce_gemm_gated": PIPE["steps"] * sched * per * 3}
    y_one = single["y"].float().cpu().numpy()
    y_scale = float(np.abs(y_one).max())
    if single["launches"] != {"sparce_gemm_gated": PIPE["steps"] * L * 3}:
        raise AssertionError(f"one rank's launches {single['launches']}")
    one = float(np.median(single["ms"]))
    log(f"  one rank, {L} layers, {TRAIN['batch']} x {TRAIN['seq']} tokens "
        f"(bf16, GLU kernel): " + ", ".join(f"{m:.1f}" for m in single["ms"])
        + f" ms a step (forward + backward of sum(y**2)); launches "
        f"{single['launches']}")
    for r, o in enumerate(outs):
        got = o["bf16"]
        if got["launches"] != want:
            raise AssertionError(f"pipeline rank {r}: launches "
                                 f"{got['launches']}, the schedule gives "
                                 f"{want}")
        y_err = float(np.abs(got["y"] - y_one).max()) / y_scale
        if not (np.isfinite(got["y"]).all() and y_err <= PIPE_BF16_REL):
            raise AssertionError(
                f"bf16 pipeline rank {r}: y off by {y_err:.2e} of one "
                f"rank's max|y| {y_scale:.4e} (limit {PIPE_BF16_REL})")
        c = got["collectives"]
        secs = sum(c["seconds"].values())
        med = float(np.median(got["ms"]))
        log(f"  pipeline rank {r} (stage {got['stage']}, {per} layers, "
            f"{PIPE['n_micro']} micro-batches, {sched} steps of the "
            f"schedule): " + ", ".join(f"{m:.1f}" for m in got["ms"])
            + f" ms a step ({med / one:.2f}x one rank's {one:.1f}); y "
              f"within {y_err:.2e} of one rank's max|y| {y_scale:.4e} "
              f"(limit {PIPE_BF16_REL}); "
            + ", ".join(f"{k} {c['counts'][k]} calls / {c[k]} B / "
                        f"{c['seconds'][k]:.3f}s" for k in c["counts"]
                        if c["counts"][k])
            + f"; {1e3 * secs / PIPE['steps']:.1f} ms a step in "
              f"collectives ({1e3 * secs / PIPE['steps'] / med:.2f} of "
              f"it); peak {got['peak_gib']:.2f} GiB; launches "
              f"{got['launches']} (= {PIPE['steps']} steps x {sched} x "
              f"{per} layers x 3) -> ok")
    # (b) the f32 run: y and every gradient against one rank's.
    worst = {}
    for r, o in enumerate(outs):
        got = o["f32"]
        pairs = [("y", got["y"], ref["y"])] + [
            (f"grad {i}", g, w[got["stage"]])
            for i, (g, w) in enumerate(zip(got["grads"], ref["grads"]))]
        for name, a, b in pairs:
            b = b.cpu().numpy()
            scale = float(np.abs(b).max()) or 1.0
            err = float(np.abs(a - b).max()) / scale
            worst[name] = max(worst.get(name, 0.0), err)
            if not err <= PIPE_F32_REL:
                raise AssertionError(
                    f"f32 pipeline rank {r}: {name} off by {err:.2e} of "
                    f"its scale (limit {PIPE_F32_REL})")
    log(f"  f32 pipeline, {PIPE_F32_LAYERS} layers: y and all "
        f"{len(worst) - 1} gradients on both ranks within "
        f"{max(worst.values()):.2e} of their scale of one rank's "
        f"(limit {PIPE_F32_REL}; y {worst['y']:.2e}) -> ok")
    return want


def run_dryrun_cells(cells=DRYRUN_CELLS, seq_shard=False, extra=()):
    """Phase 15 (c): the dry run's cells, traced on the meta device (no
    card), with ``extra`` arguments; each must report ok. Returns
    {(arch, shape, two pods): result}."""
    import tempfile
    from repro_torch.launch import dryrun
    out = {}
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        for arch, shape, two_pods in cells:
            argv = ["--arch", arch, "--shape", shape, "--out", tmp]
            argv += ["--seq-shard"] if seq_shard else []
            argv += list(extra)
            dryrun.main(argv + (["--multi-pod"] if two_pods else []))
            tag = f"{arch}_{shape}_{'pod2' if two_pods else 'pod1'}"
            with open(os.path.join(tmp, tag + ".json")) as f:
                res = json.load(f)
            if res["status"] != "ok":
                raise AssertionError(f"dry run {tag}: {res}")
            r, m = res["roofline"], res["memory"]
            c = res["collectives_scanned"]
            out[(arch, shape, two_pods)] = res
            log(f"  dry run {tag}{' --seq-shard' if seq_shard else ''}: "
                f"mesh {res['mesh']}, traced in "
                f"{res['compile_s']:.1f}s; rank 0: {res['cost_scanned']['flops']:.4g} "
                f"FLOPs, {res['cost_scanned']['bytes accessed']:.4g} B "
                f"accessed, collectives {c['total']} B in "
                f"{sum(c['counts'].values())} calls; arguments "
                f"{m['argument_size_in_bytes']} B, temp "
                f"{m['temp_size_in_bytes']} B; roofline compute "
                f"{r['t_compute']:.3e} s, memory {r['t_memory']:.3e} s, "
                f"collective {r['t_collective']:.3e} s -> {r['dominant']}")
    return out


# ----------------------- phase 16: sequence parallelism, row-cut decode
# (a) phase 14's bf16 GLU kernel run (30 layers, 8 x SP_SEQ tokens,
# TRAIN_MESH_STEPS steps) on (1, 3) with and without ``seq_shard``: 9
# heads, 3 KV heads and d_ff 1536 divide by 3, so attention and the MLP
# are both tensor-parallel; (b) one f32 step with ``seq_shard`` at
# SP_F32_LAYERS layers (GLU kernel, relu fused; 8 x SP_SEQ tokens) and
# one without, each against one rank's, loss and every gradient; (c)
# zamba2-7b at its published widths (f32, 2
# mamba2 layers, ``attn_every`` 1: two applications of the shared block)
# decoding at batch 1 over caches whose rows are cut over 2 data ranks,
# as cache_spec cuts long_500k's, against the whole cache on one rank;
# (d) the dry run's smollm-135m train_4k (16, 16) with --seq-shard
# beside phase 15's cell without it.
SP_MESH = (1, 3)
# Tokens a row: phase 14's 512 do not divide over 3 ranks (seq_parallel
# raises), so both (a) runs and (b) take 576 (8 x 576 = 36 x 128 rows).
SP_SEQ = 576
SP_JOBS = ("f32 sp glu kernel", "f32 sp relu fused", "glu kernel",
           "glu kernel sp")
SP_F32_LAYERS = 4
# The f32 step against one rank's: relative errors of the loss and the
# grad norm, and per gradient its largest elementwise error (elem) and
# its error's norm (frob), over its largest magnitude / its norm, held
# at phase 15's 1e-4 (f32 sums over the shards in another order; the
# loss at 1e-5). A relu's derivative jumps at h = 0: where the mesh's
# sums and one rank's round an h within a few ulps of 0 to opposite
# sides, the backward's mask 1[h > 0] differs there and one token's
# term of w_in's and x's gradients with it (a CPU run of the same steps
# on gloo ranks, tools/relu_tp_witness.py, finds 0-1 such elements a
# layer, under plain TP as under SP, and moves the worst gradient by
# 2.7e-3 of its scale; in f64 plain TP is within 2.1e-13). So the relu
# step is held against one rank's step whose backward takes the mesh
# run's masks, and every element where the masks differ must have |h|
# within SP_FLIP_REL of its layer's largest |h|.
SP_F32_REL = 1e-4
SP_F32_TOL = dict(loss=1e-5, gnorm=SP_F32_REL, elem=SP_F32_REL,
                  frob=SP_F32_REL)
SP_FLIP_REL = 1e-5
SP_DECODE_MESH = (2, 1)
# 8192 cache rows, 4096 a rank; 4 steps from length 4094 write rows
# 4094-4097, across the ranks' edge.
SP_DECODE = dict(rows=8192, length=4094, steps=4, seed=16)


def relu_mlp_probe(torch, masks=None):
    """A stand-in for ``sparse_ops._SparceMlp`` (the relu MLP under
    ``mode="fused"``): the same forward and backward, and each call's
    h = x @ w_in kept in call order (``.hs``), in f32 as the backward
    recomputes it; with ``masks``, call i's backward takes its relu
    mask from ``masks[i]`` in place of h > 0."""
    from repro_torch.core import sparse_ops
    base = sparse_ops._SparceMlp

    class Probe(torch.autograd.Function):
        hs = []

        @staticmethod
        def forward(ctx, x, w_in, w_out, plan, act):
            ctx.call = len(Probe.hs)
            Probe.hs.append(x.detach().float() @ w_in.detach().float())
            return base.forward(ctx, x, w_in, w_out, plan, act)

        @staticmethod
        def backward(ctx, g, bits_grad):
            if masks is None:
                return base.backward(ctx, g, bits_grad)
            x, w_in, w_out = ctx.saved_tensors
            h = x.float() @ w_in.float()
            gf = g.float()
            dh = (gf @ w_out.float().T) * masks[ctx.call].to(h.dtype)
            return ((dh @ w_in.float().T).to(x.dtype),
                    (x.float().T @ dh).to(w_in.dtype),
                    (torch.clamp_min(h, 0.0).T @ gf).to(w_out.dtype),
                    None, None)
    return Probe


@contextlib.contextmanager
def probing(torch, masks=None):
    """:func:`relu_mlp_probe` in place of ``_SparceMlp`` for the block."""
    from repro_torch.core import sparse_ops
    saved = sparse_ops._SparceMlp
    sparse_ops._SparceMlp = probe = relu_mlp_probe(torch, masks)
    try:
        yield probe
    finally:
        sparse_ops._SparceMlp = saved


def step_errors(torch, got_loss, grads, loss, want):
    """Relative errors of a step against one rank's: the loss, the grad
    norm, and the worst gradient's largest elementwise error over its
    largest magnitude (elem; ``worst``: that gradient's index, dtype and
    shape) and its error's norm over its norm (frob)."""
    def norm(gs):
        return math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in gs))

    elem = [float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
            for a, b in zip(grads, want)]
    i = int(np.argmax(elem))
    return dict(
        loss=abs(got_loss - float(loss)) / abs(float(loss)),
        gnorm=abs(norm(grads) - norm(want)) / norm(want),
        elem=elem[i],
        frob=max(float(torch.linalg.vector_norm((a - b).double()))
                 / (float(torch.linalg.vector_norm(b.double())) or 1.0)
                 for a, b in zip(grads, want)),
        worst=[i, str(want[i].dtype)[6:], list(want[i].shape)])


def sp_step_f32(torch, dev, mesh, label, dtype="float32", run=None):
    """One step of phase 12's ``label`` config (or ``run``, a TRAIN_RUNS
    row) in ``dtype``, cut to SP_F32_LAYERS layers, on this rank of
    ``mesh`` (8 x SP_SEQ tokens of phase 12's first batch), with
    ``seq_shard`` and without: the SP step's launches; on rank 0 also
    each step's errors against one rank's step on the whole model
    (:func:`step_errors`). For the relu MLP under ``mode="fused"`` each
    call's relu mask is gathered whole over 'model', and rank 0 also
    reports where each run's masks differ from one rank's ("flips": how
    many, and the largest |h| there over its call's largest |h|) and
    the errors against one rank's step whose backward takes the mesh
    run's masks ("aligned")."""
    from repro_torch.checkpoint.manager import gather_whole
    from repro_torch.models import model as model_lib
    from repro_torch.models.modules import iter_leaves
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    _, act, sparsity, kernel, per_layer = run or next(
        r for r in TRAIN_RUNS if r[0] == label)
    probe = act == "relu" and sparsity.get("mode") == "fused"
    batch = {"tokens": torch.from_numpy(
        next(train_data(seq=SP_SEQ))["tokens"]).to(dev)}
    fn = counters().get(kernel)
    out = dict(expect=per_layer * SP_F32_LAYERS, kernel=kernel)
    runs, masks = {}, {}
    for seq in (False, True):
        key = "sp" if seq else "tp"
        cfg = train_config(act, sparsity, dtype=dtype,
                           num_layers=SP_F32_LAYERS, seq_shard=seq)
        full = model_lib.init_params(cfg, seed=TRAIN["seed"], device=dev)
        params, specs = shd.train_shard_params(full, mesh)
        leaves = list(iter_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        plan = shd.TrainPlan(mesh, cfg, specs, params,
                             shd.batch_axes(mesh, TRAIN["batch"]))
        if plan.batch_size != 1 or plan.seq_parallel(cfg, SP_SEQ) != seq:
            raise AssertionError(f"{label}: the step needs a (1, M) mesh")
        if fn is not None:
            fn.launches = 0
        collectives.reset_stats()
        with contextlib.ExitStack() as stack:
            hs = stack.enter_context(probing(torch)).hs if probe else []
            stack.enter_context(shd.use_plan(plan))
            total, _, _ = model_lib.loss_terms(params, cfg, batch)
            total.backward()
        out[key + " gathers"] = gather_note(collectives.stats(), 1,
                                            plan.vocab_tp(cfg))
        if seq and fn is not None:
            out["launches"] = fn.launches
        masks[key] = [collectives.all_gather((h > 0).to(torch.uint8),
                                             "model", mesh, dim=1)
                      for h in hs]
        runs[key] = (float(total.detach()), gather_whole(
            [p.grad for p in leaves], list(shd.iter_leaves_specs(specs)),
            mesh))
    if mesh.rank != 0:
        return out
    with contextlib.ExitStack() as stack:
        hs = stack.enter_context(probing(torch)).hs if probe else []
        loss, want = value_and_grads(torch, cfg, full, batch)
    for key, (got_loss, grads) in runs.items():
        out[key] = step_errors(torch, got_loss, grads, loss, want)
        if not probe:
            continue
        out[key + " flips"] = [
            (int(d.sum()), float(h.abs()[d].max() / h.abs().max())
             if d.any() else 0.0)
            for h, d in ((h, (h > 0) != m.bool())
                         for h, m in zip(hs, masks[key]))]
        with probing(torch, masks[key]):
            _, aligned = value_and_grads(torch, cfg, full, batch)
        out[key + " aligned"] = step_errors(torch, got_loss, grads, loss,
                                            aligned)
    out.update(loss=float(loss), n_grads=len(want))
    return out


def sp_decode_case(torch, dev):
    """(cfg, full params, whole caches, tokens) of phase 16 (c): f32
    zamba2-7b at its published widths, 2 mamba2 layers each followed by
    the shared block; batch-1 caches of SP_DECODE["rows"] rows, random
    (seeded) states and rows, SP_DECODE["length"] rows in use."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=2,
                              attn_every=1, dtype="float32")
    params = model_lib.init_params(cfg, seed=SP_DECODE["seed"], device=dev)
    rng = np.random.default_rng(SP_DECODE["seed"])
    caches = model_lib.init_caches(cfg, 1, SP_DECODE["rows"], device=dev)
    for leaf in model_lib.cache_leaves(caches):
        if leaf.dtype == torch.int32:
            leaf.fill_(SP_DECODE["length"])
        else:
            leaf.copy_(torch.from_numpy(rng.standard_normal(
                tuple(leaf.shape), dtype=np.float32)))
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SP_DECODE["steps"], 1, 1)).astype(np.int32))
    return cfg, params, caches, toks


def attn_rows(caches):
    """The shared block's k and v caches: (applications, 1, rows, ...)."""
    hyb = caches["hybrid"]["attn"]
    return [hyb.k, hyb.v]


def sp_decode_rank(torch, dev, mesh):
    """Phase 16 (c) on this rank: the caches' rows cut over 'data' as
    the dry run cuts long_500k's, SP_DECODE["steps"] decode steps under
    a plan with those ``cache_rows``: each step's logits, the global
    rows it changed in this rank's slice, the merge's collectives; on
    rank 0 also the whole-cache decode's logits."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    cfg, full, caches, toks = sp_decode_case(torch, dev)
    whole = None
    if mesh.rank == 0:  # a copy for the whole-cache decode
        whole = {"hybrid": {k: type(v)(*(t.clone() for t in v))
                            for k, v in caches["hybrid"].items()}}
    params, pspecs = shd.train_shard_params(full, mesh)
    shape = ShapeConfig("decode", SP_DECODE["rows"], 1, "decode")
    plan, cspecs = dryrun.cache_plan(cfg, shape, mesh, pspecs, params,
                                     shd.batch_axes(mesh, 1), caches)
    local = shd.cut_tree(caches, cspecs, mesh, mesh.rank)
    del caches
    here = attn_rows(local)[0].shape[2]
    first = mesh.coord("data") * here
    out = dict(cache_rows=plan.cache_rows, first=first, here=here,
               logits=[], changed=[], vocab_cut=plan.vocab_tp(cfg))
    collectives.reset_stats()
    for t in toks:
        before = [a.clone() for a in attn_rows(local)]
        with torch.no_grad(), shd.use_plan(plan):
            logits, local = model_lib.decode_step(params, cfg, t.to(dev),
                                                  local)
        rows = set()
        for a, b in zip(attn_rows(local), before):
            diff = (a != b).reshape(a.shape[0] * a.shape[1], a.shape[2], -1)
            rows |= {first + int(r) for r in
                     torch.nonzero(diff.any(-1).any(0))[:, 0]}
        out["logits"].append(logits[:, -1].float().cpu().numpy())
        out["changed"].append(sorted(rows))
    torch.cuda.synchronize()
    out["collectives"] = collectives.stats()
    if whole is not None:
        want = []
        for t in toks:
            with torch.no_grad():
                logits, whole = model_lib.decode_step(full, cfg, t.to(dev),
                                                      whole)
            want.append(logits[:, -1].float().cpu().numpy())
        out["want"] = want
    return out


def sp_mesh_rank(mesh, jobs, device):
    """One rank of a phase 16 mesh: each job in turn, with its
    seconds."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        if job.startswith("f32 sp "):
            r = sp_step_f32(torch, dev, mesh, job[len("f32 sp "):])
        elif job == "row-cut decode":
            r = sp_decode_rank(torch, dev, mesh)
        else:
            r = mesh_train_run(torch, dev, mesh, job, seq=SP_SEQ)
        r["seconds"] = time.perf_counter() - t0
        out.append(r)
        torch.cuda.empty_cache()
    return out


def check_sp_counts(plain, sp, layers):
    """Phase 16 (a)'s gate on one rank: per step and layer, each
    tensor-parallel region's close (attention's wo, the MLP's w_out) is
    a reduce-scatter in the forward and an all-gather in the backward,
    and each open an all-gather in the forward and a reduce-scatter in
    the backward, in place of plain TP's two all-reduces a region; each
    of the two norms adds an all-reduce (its scale's gradient), and the
    stack's two ends an all-gather each. The embedding's partial rows
    (its vocab cut over 'model') close with a reduce-scatter in place of
    an all-reduce, its backward the first end's all-gather."""
    a, b = plain["counts"], sp["counts"]
    n = TRAIN_MESH_STEPS
    embed = 1 if sp["vocab_cut"] else 0
    want = {"reduce-scatter": (4 * layers + embed) * n,
            "all-gather": a["all-gather"] + (4 * layers + 2) * n,
            "all-reduce": a["all-reduce"] - (4 * layers + embed) * n
            + 2 * layers * n}
    got = {k: b[k] for k in want}
    if got != want or a["reduce-scatter"]:
        raise AssertionError(f"SP collectives {got}, expected {want} "
                             f"(plain TP: {a})")
    return got


def run_seq_parallel(torch, dev, cells):
    """Phase 16: (a) and (b) on SP_MESH, (c) on SP_DECODE_MESH, every rank
    a gloo process on card 0; then (d), the dry run's train_4k with
    --seq-shard beside ``cells``' cell without it (run here when phase
    15 did not)."""
    from repro_torch.launch.mesh import spawn_mesh
    rank_dev = str(dev) if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    layers = arch_config().num_layers
    for mesh, jobs in ((SP_MESH, SP_JOBS),
                       (SP_DECODE_MESH, ("row-cut decode",))):
        t0 = time.perf_counter()
        outs = spawn_mesh(sp_mesh_rank, mesh, (jobs, rank_dev),
                          device=rank_dev, backend="gloo",
                          timeout_s=TRAIN_MESH_TIMEOUT_S,
                          deadline_s=TRAIN_MESH_DEADLINE_S,
                          axes=("data", "model"))
        log(f"  mesh {mesh}: {mesh[0] * mesh[1]} ranks on card 0 (gloo), "
            f"spawn to exit {time.perf_counter() - t0:.1f}s; jobs "
            + ", ".join(f"{j} {outs[0][i]['seconds']:.1f}s"
                        for i, j in enumerate(jobs)))
        res = {j: [o[i] for o in outs] for i, j in enumerate(jobs)}
        if mesh == SP_MESH:
            check_sp_f32(res)
            check_sp_train(res, layers)
        else:
            check_row_cut_decode(res["row-cut decode"])
    if ("smollm-135m", "train_4k", False) not in cells:
        cells.update(run_dryrun_cells(DRYRUN_CELLS[:1]))
    sp = run_dryrun_cells(DRYRUN_CELLS[:1], seq_shard=True)
    plain = cells[("smollm-135m", "train_4k", False)]
    got = sp[("smollm-135m", "train_4k", False)]
    a, b = (r["memory"]["temp_size_in_bytes"] for r in (plain, got))
    if not b < a:
        raise AssertionError(f"dry run --seq-shard: temp {b} B, not below "
                             f"{a} B without it")
    c = got["collectives_scanned"]["counts"]
    log(f"  dry run smollm-135m_train_4k_pod1 --seq-shard against phase "
        f"15's cell: temp {b} B against {a} B ({b / a:.4f}); "
        f"reduce-scatter {c['reduce-scatter']} calls, all-gather "
        f"{c['all-gather']}, all-reduce {c['all-reduce']} -> ok")


def check_sp_f32(res):
    """Phase 16 (b): each rank's launches; the SP step's and plain TP's
    loss, grad norm and every gradient against one rank's within
    SP_F32_TOL. The relu step is held against one rank's step on the
    mesh run's relu masks, every element where those differ from one
    rank's own within SP_FLIP_REL of 0, and logged beside its errors
    against one rank's own masks."""
    def fmt(errs):
        return ", ".join(f"{k} {errs[k]:.2e}" for k in SP_F32_TOL)

    for label in ("glu kernel", "relu fused"):
        ranks = res[f"f32 sp {label}"]
        for r, got in enumerate(ranks):
            if got["launches"] != got["expect"]:
                raise AssertionError(
                    f"f32 sp {label} rank {r}: {got['kernel']} launched "
                    f"{got['launches']} times, expected {got['expect']}")
        r0 = ranks[0]
        relu = "sp flips" in r0
        notes = []
        for key, name in (("sp", "SP"), ("tp", "plain TP")):
            errs = r0[key + " aligned"] if relu else r0[key]
            bad = {k: v for k, v in errs.items()
                   if k in SP_F32_TOL and not v <= SP_F32_TOL[k]}
            if bad:
                raise AssertionError(
                    f"f32 {name} {label} on {SP_MESH}: {bad} against one "
                    f"rank (limits {SP_F32_TOL})")
            note = f"{name}: {fmt(errs)}"
            if relu:
                flips = r0[key + " flips"]
                worst = max(f for _, f in flips)
                if not worst <= SP_FLIP_REL:
                    raise AssertionError(
                        f"f32 {name} {label}: relu masks differ from one "
                        f"rank's where |h| reaches {worst:.2e} of its "
                        f"layer's largest (limit {SP_FLIP_REL}); per "
                        f"layer {flips}")
                note += (f" on its own relu masks, which differ from one "
                         f"rank's at {[n for n, _ in flips]} elements a "
                         f"layer, |h| there at most {worst:.2e} of the "
                         f"layer's largest; on one rank's masks "
                         f"{fmt(r0[key])}")
            notes.append(note)
        log(f"  f32 sp {label} {SP_MESH}, {SP_F32_LAYERS} layers, loss "
            f"{r0['loss']:.6f}, {r0['n_grads']} gradients; against one "
            f"rank, " + "; ".join(notes) + f" (limits {SP_F32_TOL}"
            + (f", flips within {SP_FLIP_REL}" if relu else "")
            + f"); {r0['kernel']} launched {r0['launches']} times a rank "
            f"(= per layer x {SP_F32_LAYERS}) -> ok")
        log(f"  f32 sp {label} {SP_MESH} rank 0: SP {r0['sp gathers']}; "
            f"plain TP {r0['tp gathers']}")


def check_sp_train(res, layers):
    """Phase 16 (a): both runs logged as phase 14 logs its runs, every
    rank's SP collectives gated by :func:`check_sp_counts`, each run's
    loss falling; then the SP run against plain TP per rank."""
    plain, sp = res["glu kernel"], res["glu kernel sp"]
    for label, ranks in (("glu kernel", plain), ("glu kernel sp", sp)):
        log_mesh_train(f"{label} {SP_MESH}", [[o] for o in ranks], 0)
        losses = ranks[0]["losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: losses {losses} do not fall")
    for r, (a, b) in enumerate(zip(plain, sp)):
        check_sp_counts(a["collectives"], dict(b["collectives"],
                                                vocab_cut=b["vocab_cut"]),
                        layers)
        ms = [1e3 * float(np.mean(o["dts"][1:])) for o in (a, b)]
        secs = [sum(o["collectives"]["seconds"].values()) for o in (a, b)]
        rel = max(abs(x - y) / abs(y) for x, y in
                  zip(b["losses"], a["losses"]))
        log(f"  glu kernel sp against plain TP, rank {r}: {ms[1]:.2f} "
            f"against {ms[0]:.2f} ms per step ({ms[1] / ms[0]:.3f}x); "
            f"collectives {secs[1]:.3f} against {secs[0]:.3f} s in all; "
            f"peak {b['peak_gib']:.2f} against {a['peak_gib']:.2f} GiB; "
            f"losses within {rel:.2e} of plain TP's; every row-parallel "
            f"close a reduce-scatter, every column-parallel open an "
            f"all-gather ({4 * layers} reduce-scatters a step, and the "
            f"vocab-cut embedding's close) -> ok")


def check_row_cut_decode(ranks):
    """Phase 16 (c): each step's logits on every rank within SP_F32_REL
    of their scale of the whole-cache decode's, each step's new row
    written by the rank that owns it and by no other, one all-gather a
    step and application of the shared block."""
    want = ranks[0]["want"]
    length, steps = SP_DECODE["length"], SP_DECODE["steps"]
    worst = 0.0
    for r, got in enumerate(ranks):
        if got["cache_rows"] != ("data",):
            raise AssertionError(f"row-cut decode: rows cut over "
                                 f"{got['cache_rows']}")
        for k, (a, b) in enumerate(zip(got["logits"], want)):
            err = float(np.abs(a - b).max() / np.abs(b).max())
            worst = max(worst, err)
            if not err <= SP_F32_REL:
                raise AssertionError(f"row-cut decode rank {r} step {k}: "
                                     f"logits off by {err:.2e} of scale")
            owns = got["first"] <= length + k < got["first"] + got["here"]
            if got["changed"][k] != ([length + k] if owns else []):
                raise AssertionError(
                    f"row-cut decode rank {r} step {k}: rows "
                    f"{got['changed'][k]} changed, row {length + k} is "
                    f"{'' if owns else 'not '}this rank's")
        c = got["collectives"]["counts"]
        if c["all-gather"] != 2 * steps or sum(c.values()) != 2 * steps:
            raise AssertionError(f"row-cut decode rank {r}: collectives "
                                 f"{c}, expected {2 * steps} all-gathers")
    log(f"  row-cut decode {SP_DECODE_MESH}: zamba2-7b (f32, 2 mamba2 "
        f"layers, 2 applications of the shared block), {SP_DECODE['rows']} "
        f"rows, {ranks[0]['here']} a rank, {steps} steps from length "
        f"{length}: logits within {worst:.2e} of their scale of the "
        f"whole-cache decode's (limit {SP_F32_REL}); each new row written "
        f"by its owner alone; {2 * steps} all-gathers of the softmax "
        f"states a rank; "
        + gather_note(ranks[0]["collectives"], steps, ranks[0]["vocab_cut"])
        + " -> ok")


# ------------------- phase 17: the tensor-parallel Mamba2 mixer on a mesh
# Every rank a gloo process on card 0. (a) mamba2-2.7b at its published
# widths cut to SSM_TP_LAYERS layers: TRAIN_MESH_STEPS bf16 Trainer steps
# on SSM_TP_MESH with and without ``seq_shard`` beside one rank's (phase
# 12's 8 x 512 tokens: 4096 rows a rank, at least d_model, so in_proj's
# weight is gathered and its heads' columns taken); one f32 step each
# way, held to one rank's (SSM_TP_TOL). (b)
# zamba2-7b at its published widths cut as phase 16 cuts it (2 mamba2
# layers, ``attn_every`` 1): a prefill of SSM_TP_CACHED["batch"] prompts
# and decode steps with ``h`` cut over 'model' (4 x 256 = 1024 prefill
# rows and 4 decode rows, fewer than d_model: in_proj's product is
# gathered), in f32 against one rank's, then in bf16 (the shared GLU
# through the GLU kernel at a tp-2 shard's F 7168 in decode), every
# rank's conv windows equal bit for bit. (c) the dry run's mamba2-2.7b
# train_4k on (2, 4) beside the gathered mixer's figures.
SSM_TP_MESH = (1, 2)
SSM_TP_ARCH = "mamba2-2.7b"
SSM_TP_LAYERS = 4
# 4 decode steps: a sharded step computes its vocab columns of the
# logits and gathers those (4 x 16000 f32 a rank), not the embedding and
# head (0.9 GB in f32, which held it to 2 steps before the vocab ran
# cut).
SSM_TP_CACHED = dict(batch=4, prompt=256, rows=512, steps=4, seed=17)
SSM_TP_JOBS = ("train bf16", "train bf16 sp", "step f32", "zamba2 float32",
               "zamba2 bfloat16")
# The f32 runs against one rank's: the loss and the grad norm within
# tests/test_torch_train_mesh.py's 2e-6 (relative); each gradient, and
# (b)'s logits and whole h, within phases 14-16's full-width limit of
# SP_F32_REL of its largest magnitude. The mesh tests' elementwise
# allowance (2e-4 of each value plus 2e-6 of its leaf's largest; "rtol",
# "atol") is not met at these widths by one rank's own f32 step against
# the same step with its products in f64 (up to 3.6 times it at one
# element of A_log's and dt_bias's gradients, whose SSD scan runs in f32
# in both; tools/ssm_tp_witness.py). The largest share at one element
# is a ratio of two rounding errors where a gradient is near 0, and
# moves by 2x between equivalent sound steps; and the mesh's f64 step
# differs from one rank's by as much, its f32 scan cut otherwise. So
# each f32 step is held to the f64 step of its own layout, by its whole
# rounding error (the 2-norm over a gradient leaf): the mesh's at most
# SSM_TP_F64 times one rank's. The two f64 steps are held to each other:
# the mesh's within SSM_TP_FLOOR of the 2-norm of the allowance over the
# leaf of one rank's. A lost sum over the ranks misses the second by
# thousands, a loss of precision the first.
SSM_TP_TOL = dict(loss=2e-6, gnorm=2e-6, rtol=2e-4, atol=2e-6)
SSM_TP_F64 = 2.0
SSM_TP_FLOOR = 1.0
# The dry run's mamba2-2.7b train_4k on (2, 4) with every model rank
# computing all 80 heads of the gathered mixer (the tree before the
# mixer ran tensor-parallel; tests/test_torch_dryrun.py holds the same).
SSM_TP_GATHERED = dict(temp=24994940239896, flops=9550096005857280.0)
SSM_TP_CELL = ("mamba2-2.7b", "train_4k", False)
SSM_TP_CELL_ARGS = ("--devices", "8", "--mesh", "2,4", "--no-extrapolate")


def ssm_tp_config(dtype, **fields):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SSM_TP_ARCH), dtype=dtype,
                               num_layers=SSM_TP_LAYERS, **fields)


def ssm_tp_train(torch, dev, mesh, seq_shard):
    """TRAIN_MESH_STEPS bf16 Trainer steps of mamba2-2.7b (SSM_TP_LAYERS
    layers) on phase 12's batches on this rank of ``mesh`` (or alone):
    losses, seconds a step, the collectives and peak memory."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import collectives
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    cfg = ssm_tp_config("bfloat16", seq_shard=seq_shard)
    shape = ShapeConfig("chip_smoke", TRAIN["seq"], TRAIN["batch"], "train")
    with drawn_on_card(torch):  # every rank draws the same whole params
        tr = Trainer(cfg, shape, AdamW(lr=1e-3), TrainConfig(
            steps=TRAIN_MESH_STEPS, log_every=1, seed=TRAIN["seed"]),
            mesh=mesh, device=dev)
        if mesh is not None:
            collectives.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        res = tr.run(train_data())
    torch.cuda.synchronize()
    hist = [h for h in res["history"] if "loss" in h]
    return dict(losses=[h["loss"] for h in hist],
                dts=[h["dt"] for h in hist], peak_gib=peak_gib(torch),
                collectives=collectives.stats() if mesh is not None
                else None, vocab_cut=vocab_cut(cfg, res["params"]))


def ssm_tp_step_f32(torch, dev, mesh):
    """One f32 step of mamba2-2.7b (SSM_TP_LAYERS layers,
    phase 12's first batch) on this rank of ``mesh``, with
    ``seq_shard`` and without, each against one rank's step on the whole
    model (which every rank runs, then takes its slices of): the loss's
    and grad norm's relative errors, and on this rank's slice of each
    gradient its largest error over the whole leaf's largest magnitude
    (elem) and over SSM_TP_TOL's allowance (excess); and, against one
    rank's step with its products in f64 (the scan, dt and the norms at
    the model's f32 dtype points) and the mesh's, each gradient's f32
    rounding error on the mesh over one rank's (f64: held to
    SSM_TP_F64), and the mesh's f64 step's distance from one rank's
    over the allowance (floor: held to SSM_TP_FLOOR); all 2-norms over
    the whole leaf (:func:`rounding_ratios`)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import modules
    from repro_torch.models.modules import iter_leaves
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    batch = {"tokens": torch.from_numpy(
        next(train_data())["tokens"]).to(dev)}
    cfg = ssm_tp_config("float32")
    with drawn_on_card(torch):
        full = model_lib.init_params(cfg, seed=TRAIN["seed"], device=dev)
    loss, want = value_and_grads(torch, cfg, full, batch)
    scales = [float(w.abs().max()) for w in want]
    # The port's configs name bf16 and f32; the f64 step runs the same
    # code on the same draws in f64 (the leaves the model keeps in f32,
    # such as A_log, stay so).
    modules.DTYPES.setdefault("float64", torch.float64)
    wide_cfg = ssm_tp_config("float64")
    with drawn_on_card(torch):
        wide = model_lib.init_params(wide_cfg, seed=TRAIN["seed"],
                                     device=dev)
    _, want64 = value_and_grads(torch, wide_cfg, wide, batch)
    scales64 = [float(w.abs().max()) for w in want64]

    def norm(gs, specs=None):
        sq = torch.zeros((), dtype=torch.float64, device=dev)
        for k, g in enumerate(gs):
            s = torch.sum(g.double() ** 2)
            if specs is not None and "model" in shd.spec_axes(specs[k]):
                s = collectives.psum(s.reshape(1), "model", mesh)[0]
            sq = sq + s
        return math.sqrt(float(sq))
    def mesh_step(cfg, whole):
        """This rank's loss, gradient slices, leaf specs and plan of one
        step on ``mesh``."""
        params, tree = shd.train_shard_params(whole, mesh)
        leaves = list(iter_leaves(params))
        for p in leaves:  # a replicated slice is the whole leaf itself
            p.grad = None
            p.requires_grad_(True)
        plan = shd.TrainPlan(mesh, cfg, tree, params,
                             shd.batch_axes(mesh, TRAIN["batch"]))
        with shd.use_plan(plan):
            total, _, _ = model_lib.loss_terms(params, cfg, batch)
            total.backward()
        return (total.detach(), [p.grad for p in leaves],
                list(shd.iter_leaves_specs(tree)), plan)
    out = {}
    for seq in (False, True):
        cfg = ssm_tp_config("float32", seq_shard=seq)
        collectives.reset_stats()
        total, grads, specs, plan = mesh_step(cfg, full)
        if not plan.mixer_tp(cfg) or plan.seq_parallel(
                cfg, TRAIN["seq"]) != seq:
            raise AssertionError("phase 17: the step needs a (1, M) mesh "
                                 "whose M divides the heads")
        gathers = gather_note(collectives.stats(), 1, plan.vocab_tp(cfg))
        _, grads64, _, _ = mesh_step(
            ssm_tp_config("float64", seq_shard=seq), wide)
        mine = [shd.shard_of(w, s, mesh, mesh.rank)
                for w, s in zip(want, specs)]
        excess = [allowance_used(g, w, scale=a)
                  for g, w, a in zip(grads, mine, scales)]
        elem = [float((g - w).abs().max()) / max(a, 1e-30)
                for g, w, a in zip(grads, mine, scales)]
        read = []
        for g, g64, w, w64, s, a in zip(grads, grads64, mine, want64,
                                        specs, scales64):
            sq = rounding_reading(g, g64, w, shd.shard_of(
                w64, s, mesh, mesh.rank), a)
            if "model" in shd.spec_axes(s):  # the whole leaf's
                sq = collectives.psum(sq, "model", mesh)
            read.append(rounding_ratios(sq))
        f64 = [r[0] for r in read]
        floor = [r[1] for r in read]
        out["sp" if seq else "tp"] = dict(
            f64=max(f64), worst_f64=int(np.argmax(f64)),
            floor=max(floor), worst_floor=int(np.argmax(floor)),
            loss=abs(float(total) - float(loss)) / abs(float(loss)),
            gnorm=abs(norm(grads, specs) - norm(want)) / norm(want),
            elem=max(elem), worst=int(np.argmax(elem)),
            excess=max(excess), worst_excess=int(np.argmax(excess)),
            n=len(want), value=float(loss), gathers=gathers)
        del grads, grads64
        torch.cuda.empty_cache()
    return out


def ssm_tp_cached(torch, dev, mesh, dtype):
    """zamba2-7b (SSM_TP_CACHED, 2 mamba2 layers, ``attn_every`` 1,
    ``dtype``, phase 4's sparsity) on this rank of ``mesh``: a prefill
    into caches cut as the dry run cuts a decode's, then decode steps,
    under a plan; each step's logits, ms a decode step, the kernels'
    launches, this rank's ssm states' shapes and its conv windows, and
    ``h`` gathered whole; on rank 0 also one rank's run on the whole
    model and caches."""
    from repro_torch.checkpoint.manager import gather_whole
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.parallel import collectives
    from repro_torch.parallel import sharding as shd
    c = SSM_TP_CACHED
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=2,
                              attn_every=1, dtype=dtype,
                              sparsity=glu_sparsity())
    with drawn_on_card(torch):
        full = model_lib.init_params(cfg, seed=c["seed"], device=dev)
    rng = np.random.default_rng(c["seed"])
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (c["batch"], c["prompt"])).astype(np.int32))
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (c["steps"], c["batch"], 1)).astype(np.int32))

    def run(params, caches, plan, rows):
        """The prefill and the decode steps: logits (the prefill's last
        row, then each step's), ms a decode step, the launches."""
        wrappers = counters()
        for fn in wrappers.values():
            fn.launches = 0
        logits, dts = [], []
        t1 = time.perf_counter()
        for i, t in enumerate([prompt] + list(toks)):
            t = shd.shard_of(t, rows, mesh, mesh.rank).to(dev) if plan \
                else t.to(dev)
            torch.cuda.synchronize()
            if plan is not None and i == 1:  # the decode steps'
                collectives.reset_stats()
            t0 = time.perf_counter()
            with torch.no_grad(), shd.use_plan(plan):
                lg, caches, _ = model_lib.forward(params, cfg,
                                                  {"tokens": t}, caches)
            torch.cuda.synchronize()
            (dts.append if i else steps.append)(time.perf_counter() - t0)
            logits.append(lg[:, -1].float())
        steps.append(time.perf_counter() - t1)
        return logits, dts, caches, {k: fn.launches for k, fn in
                                     wrappers.items() if fn.launches}

    steps = [time.perf_counter() - t0]  # init, prefill, prefill+decode
    params, pspecs = shd.train_shard_params(full, mesh)
    shape = ShapeConfig("decode", c["rows"], c["batch"], "decode")
    axes = shd.batch_axes(mesh, c["batch"])
    whole_caches = model_lib.init_caches(cfg, c["batch"], c["rows"],
                                         device=dev)
    plan, cspecs = dryrun.cache_plan(cfg, shape, mesh, pspecs, params, axes,
                                     whole_caches)
    local = shd.cut_tree(whole_caches, cspecs, mesh, mesh.rank)
    rows = (axes, None)
    logits, dts, local, launches = run(params, local, plan, rows)
    gathers = gather_note(collectives.stats(), c["steps"],
                          plan.vocab_tp(cfg))
    logits = [g.cpu().numpy() for g in gather_whole(
        logits, [rows] * len(logits), mesh)]
    h, conv, hspec = [], [], []

    def leaf(path, x, spec):
        if path[-1] == "h":
            h.append(x)
            hspec.append(spec)
        elif path[-1] == "conv":
            conv.append(x.cpu().contiguous().view(torch.uint8).numpy())
    dryrun._zip_map(leaf, local, cspecs)
    out = dict(mixer_tp=plan.mixer_tp(cfg), ms=1e3 * float(np.mean(dts)),
               launches=launches, h_shapes=[tuple(x.shape) for x in h],
               h_specs=hspec, conv=conv,
               h=[x.cpu().numpy() for x in gather_whole(h, hspec, mesh)],
               logits=logits, peak_gib=peak_gib(torch), steps_s=steps,
               gathers=gathers)
    if mesh.rank != 0:
        out.update(h=None, logits=None)
        return out
    one = model_lib.init_caches(cfg, c["batch"], c["rows"], device=dev)
    want, wdts, one, wl = run(full, one, None, None)
    wh = []
    dryrun._zip_map(lambda path, x, _: wh.append(x.cpu().numpy())
                    if path[-1] == "h" else None, one, one)
    out.update(want=[g.cpu().numpy() for g in want], want_h=wh,
               want_ms=1e3 * float(np.mean(wdts)), want_launches=wl)
    return out


def ssm_tp_rank(mesh, jobs, device):
    """One rank of phase 17's mesh: each job in turn, with its
    seconds."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        if job.startswith("train"):
            r = ssm_tp_train(torch, dev, mesh, job.endswith(" sp"))
        elif job == "step f32":
            r = ssm_tp_step_f32(torch, dev, mesh)
        else:
            r = ssm_tp_cached(torch, dev, mesh, job.split()[1])
        r["seconds"] = time.perf_counter() - t0
        out.append(r)
        torch.cuda.empty_cache()
    return out


def check_ssm_tp_train(res, single):
    """Phase 17 (a): each bf16 run's losses finite and equal on every
    rank, logged beside one rank's ms a step with its collectives and
    peak memory; the f32 step within SSM_TP_TOL's loss and grad norm
    limits of one rank's, each gradient within SP_F32_REL, and against
    the f64 step within SSM_TP_F64 and SSM_TP_FLOOR
    (:func:`rounding_ratios`)."""
    for job in ("train bf16", "train bf16 sp"):
        ranks, one = res[job], single[job]
        label = f"{SSM_TP_ARCH} ({SSM_TP_LAYERS} layers) {job[6:]} {SSM_TP_MESH}"
        ms1 = 1e3 * float(np.mean(one["dts"][1:]))
        for r, got in enumerate(ranks):
            if not (np.isfinite(got["losses"]).all()
                    and got["losses"] == ranks[0]["losses"]):
                raise AssertionError(f"{label} rank {r}: losses "
                                     f"{got['losses']}")
            c = got["collectives"]
            ms = 1e3 * float(np.mean(got["dts"][1:]))
            log(f"  {label} rank {r}: {ms:.1f} ms a step against one "
                f"rank's {ms1:.1f} ({ms / ms1:.2f}x; step 0 "
                f"{1e3 * got['dts'][0]:.1f} ms); peak {got['peak_gib']:.2f}"
                f" GiB (one rank {one['peak_gib']:.2f}); collectives "
                + ", ".join(f"{k} {c['counts'][k]} calls / {c[k]} B / "
                            f"{c['seconds'][k]:.3f}s" for k in c["counts"]
                            if c["counts"][k])
                + f"; losses {['%.4f' % v for v in got['losses']]} (one "
                  f"rank {['%.4f' % v for v in one['losses']]}); "
                + gather_note(c, TRAIN_MESH_STEPS, got["vocab_cut"]))
        if not ranks[0]["collectives"]["counts"]["reduce-scatter"]:
            raise AssertionError(f"{label}: no reduce-scatter: the mixer's "
                                 "columns were not gathered with a summed "
                                 "gradient")
    tol = SSM_TP_TOL
    for key, name in (("tp", "plain TP"), ("sp", "seq_shard")):
        e = max((r[key] for r in res["step f32"]), key=lambda e: e["elem"])
        x = max(r[key]["excess"] for r in res["step f32"])
        w = max((r[key] for r in res["step f32"]), key=lambda e: e["f64"])
        f = max((r[key] for r in res["step f32"]), key=lambda e: e["floor"])
        if not (e["loss"] <= tol["loss"] and e["gnorm"] <= tol["gnorm"]
                and e["elem"] <= SP_F32_REL and w["f64"] <= SSM_TP_F64
                and f["floor"] <= SSM_TP_FLOOR):
            raise AssertionError(f"f32 {name} step on {SSM_TP_MESH}: {e}, "
                                 f"f64 {w['f64']} (leaf {w['worst_f64']}), "
                                 f"floor {f['floor']} (leaf "
                                 f"{f['worst_floor']}) against one rank "
                                 f"(limits {tol}, elem {SP_F32_REL}, f64 "
                                 f"{SSM_TP_F64}, floor {SSM_TP_FLOOR})")
        log(f"  f32 {name} step {SSM_TP_ARCH} ({SSM_TP_LAYERS} layers) on "
            f"{SSM_TP_MESH}, loss {e['value']:.6f}: against one rank loss "
            f"{e['loss']:.2e}, grad norm {e['gnorm']:.2e} (limits "
            f"{tol['loss']}), all {e['n']} gradients within {e['elem']:.2e}"
            f" of their largest (limit {SP_F32_REL}; worst leaf "
            f"{e['worst']}); against the f64 step of its layout each "
            f"gradient's rounding error is at most {w['f64']:.3f} "
            f"times one rank's (limit {SSM_TP_F64}; worst leaf "
            f"{w['worst_f64']}), the mesh's f64 step from one rank's at "
            f"most {f['floor']:.3f} of the allowance (limit "
            f"{SSM_TP_FLOOR}; worst leaf {f['worst_floor']}); {x:.3f} of "
            f"the allowance at one element against one rank's f32 step "
            f"(rtol {tol['rtol']}, atol {tol['atol']}: logged) -> ok")
        log(f"  f32 {name} step on {SSM_TP_MESH}, every rank: "
            + "; ".join(r[key]["gathers"] for r in res["step f32"]))


def check_ssm_tp_cached(res):
    """Phase 17 (b): the mixer tensor-parallel, ``h`` cut over the heads,
    the conv windows bit-equal on both ranks; f32 logits and the whole
    ``h`` within SP_F32_REL of their largest of one rank's; bf16 logits
    finite and the GLU kernel launched once an application a decode
    step on every rank, as on one rank."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-7b")
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.head_dim
    M = SSM_TP_MESH[1]
    c = SSM_TP_CACHED
    tol = SSM_TP_TOL
    for job in ("zamba2 float32", "zamba2 bfloat16"):
        ranks = res[job]
        r0 = ranks[0]
        for r, got in enumerate(ranks):
            if not got["mixer_tp"] or any(sh[-3] != H // M
                                          for sh in got["h_shapes"]):
                raise AssertionError(f"{job} rank {r}: h {got['h_shapes']}"
                                     f" is not cut over {M} ranks' heads")
            for a, b in zip(got["conv"], r0["conv"]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{job} rank {r}: conv window "
                                         "differs from rank 0's")
        if job == "zamba2 float32":
            worst, x = 0.0, 0.0
            for name, got, want in ([("logits", a, b) for a, b in zip(
                    r0["logits"], r0["want"])] + [("h", a, b) for a, b in zip(
                    r0["h"], r0["want_h"])]):
                err = float(np.abs(got - want).max() / np.abs(want).max())
                worst = max(worst, err)
                x = max(x, allowance_used(got, want))
                if not err <= SP_F32_REL:
                    raise AssertionError(f"{job}: {name} off by {err:.2e} "
                                         "of its largest against one rank")
            note = (f"logits ({len(r0['logits'])} steps) and h within "
                    f"{worst:.2e} of their largest of one rank's (limit "
                    f"{SP_F32_REL}; {x:.3f} of the mesh tests' allowance)")
        else:
            expect, one = (ssm_tp_glu_launches(M), ssm_tp_glu_launches(1))
            if not expect["sparce_glu_mlp_fused"]:
                raise AssertionError(f"{job}: the planner runs no GLU "
                                     "kernel on the mesh")
            for r, got in enumerate(ranks):
                if got["launches"] != expect:
                    raise AssertionError(f"{job} rank {r}: launches "
                                         f"{got['launches']}, expected "
                                         f"{expect}")
            if r0["want_launches"] != one or not all(
                    np.isfinite(x).all() for x in r0["logits"]):
                raise AssertionError(f"{job}: one rank's launches "
                                     f"{r0['want_launches']} (expected "
                                     f"{one}) or logits")
            note = (f"logits finite; launches {expect} a rank, where the "
                    f"planner picks the kernel (one rank {one})")
        log(f"  {job} {SSM_TP_MESH}: {c['batch']} x {c['prompt']} prefill "
            f"then {c['steps']} decode steps, {r0['ms']:.1f} ms a step "
            f"against one rank's {r0['want_ms']:.1f}; h {r0['h_shapes'][0]}"
            f" a rank ({H // M} of {H} heads), conv windows bit-equal on "
            f"both ranks; {note}; peak {r0['peak_gib']:.2f} GiB; init, "
            f"prefill, run, one rank's prefill, run "
            f"{[round(x, 2) for x in r0['steps_s']]} s -> ok")
        for r, got in enumerate(ranks):
            log(f"  {job} {SSM_TP_MESH} rank {r} decode: {got['gathers']}; "
                f"peak {got['peak_gib']:.2f} GiB")


def ssm_tp_glu_launches(M):
    """The GLU kernel's launches a rank of (1, M) in phase 17 (b)'s bf16
    run: one per application of the shared block in each forward (the
    prefill, then each decode step) whose rows the planner runs
    ``fused`` at the rank's F = d_ff / M."""
    from repro_torch.configs import get_config
    c = SSM_TP_CACHED
    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=2,
                              attn_every=1, dtype="bfloat16")
    lcfg = dataclasses.replace(cfg, d_ff=cfg.d_ff // M)
    rows = [c["batch"] * c["prompt"]] + [c["batch"]] * c["steps"]
    apps = cfg.num_layers // cfg.attn_every
    return {"sparce_glu_mlp_fused": apps * sum(
        glu_variant(lcfg, n) == "fused" for n in rows)}


def allowance_used(got, want, tol=SSM_TP_TOL, scale=None):
    """The largest |got - want| over its allowance, rtol |want| plus
    atol of ``scale`` (default: want's largest magnitude;
    ``np.testing.assert_allclose``'s rule: at most 1 passes)."""
    import torch
    got, want = (torch.as_tensor(t).double() for t in (got, want))
    scale = max(float(want.abs().max()) if scale is None else scale,
                1e-30)
    return float(((got - want).abs() / (
        tol["atol"] * scale + tol["rtol"] * want.abs())).max())


def rounding_reading(got, got64, one, one64, scale64, tol=SSM_TP_TOL):
    """The squared 2-norms behind phase 17's f64 reading of one gradient
    slice, f64 (4,): the mesh's f32 slice ``got`` minus its f64 slice
    ``got64``; one rank's f32 slice ``one`` minus its f64 slice
    ``one64``; the mesh's f64 slice minus one rank's; and SSM_TP_TOL's
    allowance (rtol |one64| plus atol of the whole leaf's largest,
    ``scale64``). Summed over the ranks that hold a leaf's slices,
    :func:`rounding_ratios` reads them."""
    import torch
    got, got64, one, one64 = (torch.as_tensor(t).double()
                              for t in (got, got64, one, one64))
    allow = tol["atol"] * max(scale64, 1e-30) + tol["rtol"] * one64.abs()
    return torch.stack([torch.sum(d ** 2) for d in (
        got - got64, one - one64, got64 - one64, allow)])


def rounding_ratios(sq):
    """(ratio, floor) of a leaf's summed :func:`rounding_reading`: each
    f32 step against the f64 step of its own layout, the mesh's rounding
    error over one rank's (0 where the mesh's is 0); and the mesh's f64
    step's distance from one rank's over the allowance."""
    mesh, alone, floor, allow = (float(v) for v in sq)
    return (math.sqrt(mesh / max(alone, 1e-300)) if mesh else 0.0,
            math.sqrt(floor / allow))


def run_ssm_tp(torch, dev):
    """Phase 17: one rank's bf16 runs here, then SSM_TP_JOBS on
    SSM_TP_MESH spawned on card 0 (gloo); then (c), the dry run's cell.
    Returns the time rows of the kernel at the shapes it ran."""
    from repro_torch.launch.mesh import spawn_mesh
    single = {}
    for job in ("train bf16", "train bf16 sp"):
        single[job] = ssm_tp_train(torch, dev, None, job.endswith(" sp"))
        torch.cuda.empty_cache()
    rank_dev = str(dev) if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    t0 = time.perf_counter()
    outs = spawn_mesh(ssm_tp_rank, SSM_TP_MESH, (SSM_TP_JOBS, rank_dev),
                      device=rank_dev, backend="gloo",
                      timeout_s=TRAIN_MESH_TIMEOUT_S,
                      deadline_s=TRAIN_MESH_DEADLINE_S,
                      axes=("data", "model"))
    log(f"  mesh {SSM_TP_MESH}: {SSM_TP_MESH[1]} ranks on card 0 (gloo), "
        f"spawn to exit {time.perf_counter() - t0:.1f}s; jobs "
        + ", ".join(f"{j} {outs[0][i]['seconds']:.1f}s"
                    for i, j in enumerate(SSM_TP_JOBS)))
    res = {j: [o[i] for o in outs] for i, j in enumerate(SSM_TP_JOBS)}
    check_ssm_tp_cached(res)
    check_ssm_tp_train(res, single)
    got = run_dryrun_cells((SSM_TP_CELL,), extra=SSM_TP_CELL_ARGS)[
        SSM_TP_CELL]
    temp = got["memory"]["temp_size_in_bytes"]
    flops = got["cost_scanned"]["flops"]
    a, f = SSM_TP_GATHERED["temp"], SSM_TP_GATHERED["flops"]
    if not (temp < a and flops < 0.4 * f):
        raise AssertionError(f"dry run {SSM_TP_CELL}: temp {temp} B, FLOPs "
                             f"{flops} against the gathered mixer's {a}, {f}")
    log(f"  dry run mamba2-2.7b_train_4k (2, 4) against the gathered "
        f"mixer's cell: temp {temp} B against {a} ({temp / a:.4f}); FLOPs "
        f"a rank {flops:.6g} against {f:.6g} ({flops / f:.4f}) -> ok")
    rng = np.random.default_rng(17)
    return [glu_row(torch, dev, rng, "sparce_glu_mlp_fused zamba2-7b tp 2 "
                    "shard decode", M=SSM_TP_CACHED["batch"], K=3584,
                    F_=7168, N=3584, act="silu")]


# Phase 18: SASA's measuring autotuner on the card. (label, M, K, F, N,
# dtype, measured block sparsity): the relu decode tick in bf16 and
# f32, a 256-row prefill bucket, a training step's forward (8 x 512
# rows, row 3b's shape) at 0.5 and at 0, and a tp-3 training shard's.
AUTOTUNE_CASES = (
    ("relu decode tick", 8, 576, 1536, 576, "bfloat16", 0.5),
    ("relu decode tick", 8, 576, 1536, 576, "float32", 0.5),
    ("prefill bucket", 256, 576, 1536, 576, "bfloat16", 0.5),
    ("training step", TRAIN["batch"] * TRAIN["seq"], 576, 1536, 576,
     "bfloat16", 0.5),
    ("training step", TRAIN["batch"] * TRAIN["seq"], 576, 1536, 576,
     "bfloat16", 0.0),
    ("tp 3 training shard", TRAIN["batch"] * TRAIN["seq"], 576, TP3_F, 576,
     "bfloat16", 0.5),
)
AUTOTUNE_ITERS = 20
# The candidates' y against each other and the plain version, relative
# to the plain version's largest |y| (the synthetic operands are not at
# init scale): f32 sums in another order; bf16 roundings of h (the
# two-kernel path's library up-projection writes it in bf16) and of y.
AUTOTUNE_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}


def autotune_decode_inputs(torch, dev, dtype, shape, block_f, s, seed=18):
    """(x, w_in, w_out) for a plan with one row tile, where the
    autotuner's row clusters cannot realize any sparsity (round(s) of
    one cluster): positive x and |w_in| with round(s * stripes) of its
    block_f column stripes negated, so those stripes are dead;
    ``w_out * 0.05`` as the autotuner draws it."""
    M, K, F_, N = shape
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((M, K), dtype=np.float32))
    wi = np.abs(rng.standard_normal((K, F_), dtype=np.float32))
    nf = -(-F_ // block_f)
    for f in rng.permutation(nf)[:int(round(s * nf))]:
        wi[:, f * block_f:(f + 1) * block_f] *= -1.0
    wo = rng.standard_normal((F_, N), dtype=np.float32) * np.float32(0.05)
    dt = getattr(torch, dtype)
    return tuple(torch.from_numpy(a).to(dev, dt) for a in (x, wi, wo))


def autotune_case(torch, dev, label, M, K, F_, N, dtype, s):
    """One shape of phase 18: ``autotune_mlp_plan`` with its launch
    counts read around it and a second call, then both candidates at the
    tuned plan against each other and the plain version (bits exactly),
    and each candidate's CUDA-events time; one line of model against
    measurement."""
    from repro_torch.core import sasa, sparse_ops
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import relu_bitmap as rb
    from repro_torch.kernels import sparce_gemm as sg
    from repro_torch.kernels import sparce_mlp as sm
    model = sasa.plan_mlp(M, K, F_, N, measured_block_sparsity=s,
                          dtype=dtype)
    sample = None
    if M <= model.block_m:
        sample = autotune_decode_inputs(torch, dev, dtype, (M, K, F_, N),
                                        model.block_f, s)
    kernels = (sm.sparce_mlp_fused, rb.relu_bitmap, sg.sparce_gemm_gated)
    kw = dict(measured_block_sparsity=s, dtype=dtype, sample_inputs=sample,
              iters=AUTOTUNE_ITERS, device=dev)
    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    tuned = sasa.autotune_mlp_plan(M, K, F_, N, **kw)
    seconds = time.perf_counter() - t0
    moved = [k.launches - b for k, b in zip(kernels, before)]
    name = f"autotune {label} {M}x{K}x{F_}x{N} {dtype} s={s}"
    if moved != [AUTOTUNE_ITERS + 1] * 3:
        raise AssertionError(f"{name}: launches {moved} (sparce_mlp_fused, "
                             "relu_bitmap, sparce_gemm_gated), want "
                             f"{AUTOTUNE_ITERS + 1} each")
    if sasa.autotune_mlp_plan(M, K, F_, N, **kw) is not tuned:
        raise AssertionError(f"{name}: a second call was not memoised")
    plan, timings = tuned
    if plan.variant != min(timings, key=timings.get):
        raise AssertionError(f"{name}: winner {plan.variant} of {timings}")
    if dataclasses.replace(plan, variant=model.variant) != model:
        raise AssertionError(f"{name}: {plan} is not plan_mlp's {model}")
    x, wi, wo = sample or sasa.mlp_sample_inputs(
        M, K, F_, N, block_m=plan.block_m, measured_block_sparsity=s,
        dtype=dtype, device=dev)
    blocks = dict(block_m=plan.block_m, block_f=plan.block_f)
    fused = lambda: kops.sparce_mlp_fused(x, wi, wo, **blocks)  # noqa: E731
    two = lambda: sparse_ops.two_kernel_mlp(x, wi, wo, plan)  # noqa: E731
    y_f, bmp = fused()
    y_t, bits_t = two()
    y_0, bits_0 = sm.sparce_mlp_fused_plain(x, wi, wo, **blocks)
    torch.cuda.synchronize()
    if not (torch.equal(bmp.bits, bits_0) and torch.equal(bits_t, bits_0)):
        raise AssertionError(f"{name}: the candidates' bits differ")
    tol = AUTOTUNE_TOLS[dtype]
    atol = tol * y_0.float().abs().max().item()
    why = f"{tol} of the largest |y|"
    err_f = check_close(f"{name} fused", y_f, y_0, atol=atol, rtol=tol,
                        why=why)
    err_t = check_close(f"{name} two_kernel", y_t, y_0, atol=atol, rtol=tol,
                        why=why)
    check_close(f"{name} two_kernel vs fused", y_t, y_f, atol=atol,
                rtol=tol, why=why)
    ev = {"fused": cuda_time_ms(fused, AUTOTUNE_ITERS),
          "two_kernel": cuda_time_ms(two, AUTOTUNE_ITERS)}
    by = model.modeled()
    realized = bits_0.float().mean().item()
    agree = plan.variant == model.variant
    tall = (sm.tall_path(M, K, F_, N, dtype=x.dtype, **blocks),
            sg.tall_path(M, F_, N, block_m=plan.block_m,
                         block_k=plan.block_f, dtype=x.dtype))
    log(f"  {label} {M}x{K}x{F_}x{N} {dtype} s={s}: tiles "
        f"({plan.block_m}, {plan.block_f}), realized tile sparsity "
        f"{realized:.4f} ({int(bits_0.sum())}/{bits_0.numel()}); model "
        f"{model.variant} (bytes fused {by['fused']}, two_kernel "
        f"{by['two_kernel']}); host ms a call fused "
        f"{1e3 * timings['fused']:.4f}, two_kernel "
        f"{1e3 * timings['two_kernel']:.4f}; events ms fused "
        f"{ev['fused']:.4f}, two_kernel {ev['two_kernel']:.4f}; winner "
        f"{plan.variant} agree={agree}; max_abs_err fused {err_f:.3e}, "
        f"two_kernel {err_t:.3e}; tuned in {seconds:.1f}s; tall path: "
        f"fused {tall[0]}, two_kernel's gated GEMM {tall[1]}")
    return dict(label=label, shape=(M, K, F_, N), dtype=dtype, s=s,
                realized=realized, model=model.variant, winner=plan.variant,
                agree=agree, timings=timings, events=ev)


def run_examples(argv_by_name):
    """Each port example's ``main`` from ``examples/``, in this process;
    fails unless it returns 0."""
    import importlib.util
    for name, argv in argv_by_name:
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        t0 = time.perf_counter()
        rc = module.main(argv)
        if rc != 0:
            raise AssertionError(f"examples/{name}.py {argv}: exit {rc}")
        log(f"  examples/{name}.py {' '.join(argv)}: exit 0 in "
            f"{time.perf_counter() - t0:.1f}s")


def run_autotune(torch, dev):
    """Phase 18: AUTOTUNE_CASES, then the quickstart and the GEMM demo
    on the card. Model and measurement disagreeing is logged, not a
    failure."""
    from repro_torch.core import sasa
    sasa.plan_cache_clear()
    res = [autotune_case(torch, dev, *case) for case in AUTOTUNE_CASES]
    off = [f"{r['label']} {r['dtype']} s={r['s']}" for r in res
           if not r["agree"]]
    log(f"  the byte model's variant agreed with the measured winner at "
        f"{len(res) - len(off)} of {len(res)} shapes"
        + (f"; not at: {', '.join(off)}" if off else ""))
    where = f"cuda:{dev.index or 0}"
    run_examples((("torch_quickstart", ["--device", where]),
                  ("torch_sparse_gemm_demo", ["--device", where])))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,"
                            "18",
                    help="comma-separated subset of phases to run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    t_start = time.perf_counter()
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
        glu_metrics = None
        cells = {}  # the dry run's results, by (arch, shape, two pods)
        t_phase = time.perf_counter()

        def phase_done(n):
            nonlocal t_phase
            log(f"phase {n}: {time.perf_counter() - t_phase:.1f}s")
            t_phase = time.perf_counter()

        if 2 in phases:
            log("phase 2: kernels vs plain versions on the card")
            errs["paged_gqa_decode_attn"] = check_attention(torch, dev)
            check_attention_aliased(torch, dev)
            errs["sparce_glu_mlp_fused"] = check_glu(torch, dev)
            errs["relu_bitmap"] = check_relu_bitmap(torch, dev)
            errs["sparce_gemm_gated"] = check_gemm(torch, dev)
            check_train_gemm(torch, dev)
            errs["sparce_mlp_fused"] = check_mlp(torch, dev)
            errs["paged_mla_decode_attn"] = check_mla(torch, dev)
            errs["sparce_gemm_compacted"] = check_compacted(torch, dev)
            errs["sparce_gemm_gated_both"] = check_both(torch, dev)
            errs["relu_bwd_bitmap"] = check_relu_bwd(torch, dev)
            phase_done(2)
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
            phase_done(3)
        rows = []
        if 4 in phases:
            log("phase 4: full-width bf16 gated-GLU engine")
            glu_metrics, launches = run_glu_engine(torch, dev)
            rows += [time_attention(torch, dev,
                                    errs.get("paged_gqa_decode_attn")),
                     time_glu(torch, dev, errs.get("sparce_glu_mlp_fused"))]
            for row in rows:
                row["launches"] = launches[row["name"]]
            phase_done(4)
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
            phase_done(5)
        if 6 in phases:
            log("phase 6: full-width bf16 DeepSeek-V3 engine (MLA + MoE, "
                f"{DEEPSEEK_DEPTH['num_layers']} layers), then an f32 "
                "2-layer decode step, kernels vs plain")
            launches = run_deepseek(torch, dev)
            row = time_mla(torch, dev, errs.get("paged_mla_decode_attn"))
            row["launches"] = launches["paged_mla_decode_attn"]
            rows.append(row)
            phase_done(6)
        if 7 in phases:
            log("phase 7: the paper's evaluation path: the AlexNet GEMM "
                "table at its published shapes (f32) under fig14's plans, "
                "then launch.figures --figs 17,18,demo")
            rows += run_phase7(torch, dev, errs)
            phase_done(7)
        if 8 in phases:
            log("phase 8: full-width bf16 prefix-cache engine (GLU fused, "
                "paged attention) on a shared-prefix trace, cache off then "
                "on; then f32 2-layer streams, cache off against on")
            run_prefix_engine(torch, dev)
            phase_done(8)
        if 9 in phases:
            log("phase 9: the live engine: serve_trace of an open-loop "
                "trace under the SLO scheduler with preemption, shedding "
                "and faults (full-width bf16 GLU, twice), then f32 2-layer "
                "relu kernel engine card vs CPU, then AsyncServer")
            run_live_engine(torch, dev)
            check_live_f32(torch, dev)
            run_live_async(torch, dev)
            phase_done(9)
        if 10 in phases:
            log("phase 10: the contiguous KV layout: phase 4's GLU engine "
                "contiguous; mamba2-2.7b (32 layers) and zamba2-7b (15 "
                "layers) at full "
                "width, then their f32 2-layer steps card vs CPU; "
                "smollm-360m, mistral-nemo-12b, qwen1.5-110b and "
                "qwen2-moe-a2.7b paged engines at full width")
            launches = {"smollm-135m contiguous": run_contiguous_glu(
                torch, dev, glu_metrics)}
            launches.update(run_ssm_engines(torch, dev))
            launches.update(run_new_configs(torch, dev))
            time_rows(torch, dev, phase10_rows(torch, dev))
            for label, counts in launches.items():
                log(f"  phase 10 launches, {label}: "
                    f"{ {k: v for k, v in counts.items() if v} }")
            phase_done(10)
        if 11 in phases:
            log("phase 11: the vlm and audio frontends: musicgen-large "
                "whole and pixtral-12b (8 layers) at full width as bf16 "
                "paged engines, then their f32 2-layer steps card vs CPU")
            for label, counts in run_frontends(torch, dev).items():
                log(f"  phase 11 launches, {label}: "
                    f"{ {k: v for k, v in counts.items() if v} }")
            phase_done(11)
        if 12 in phases:
            log("phase 12: training: Trainer.run on smollm-135m at full "
                "width (bf16, 8 x 512 tokens, 20 steps), GLU kernel, relu "
                "fused and dense; then an f32 2-layer step card vs CPU and "
                "a checkpointed restart")
            for label, counts in run_training(torch, dev).items():
                log(f"  phase 12 launches, {label}: "
                    f"{ {k: v for k, v in counts.items() if v} }")
            check_train_step_f32(torch, dev)
            check_restart(torch, dev)
            phase_done(12)
        if phases & {11, 12}:
            time_rows(torch, dev, slice_rows(torch, dev))
            if 12 in phases:
                rows += tall_kernel_rows(torch, dev)
            phase_done("11-12 timing")
        if 13 in phases:
            log("phase 13: serving on a (data, model) mesh, every rank on "
                "card 0 over gloo: the bf16 GLU engine on (1, 3), the bf16 "
                "--sparce relu engine (fused, kernel) on (2, 1), then f32 "
                "2-layer engines on both against the single rank")
            run_mesh_engines(torch, dev)
            time_rows(torch, dev, phase13_rows(torch, dev))
            phase_done(13)
        if 14 in phases:
            log("phase 14: training on a (data, model) mesh, every rank on "
                f"card 0 over gloo: {MESH_F32_STEPS} f32 full-width "
                "smollm-135m steps on (1, 3) and, with ZeRO-1, on (2, 1) "
                "against the single rank's; the bf16 GLU "
                "kernel run on (1, 3) and the relu fused run with ZeRO-1 on "
                f"(2, 1), {TRAIN_MESH_STEPS} steps; qwen2-moe-a2.7b "
                "(2 layers) expert-parallel on (1, 2)")
            run_train_meshes(torch, dev)
            time_rows(torch, dev, phase14_rows(torch, dev))
            phase_done(14)
        if 15 in phases:
            log("phase 15: smollm-135m's 30 layers (bf16, GLU kernel) as a "
                f"{PIPE_STAGES}-stage pipeline over 'pod', every rank on "
                "card 0 over gloo, against one rank; the f32 pipeline at "
                f"{PIPE_F32_LAYERS} layers against one rank; then the dry "
                "run's cells on the meta device")
            for name, n in run_pipeline(torch, dev).items():
                log(f"  phase 15 launches a rank, {name}: {n}")
            time_rows(torch, dev, train_gemm_rows(
                torch, dev, 11, "pipeline micro-batch", M=PIPE_MICRO_ROWS))
            cells.update(run_dryrun_cells())
            phase_done(15)
        if 16 in phases:
            log("phase 16: sequence parallelism, every rank on card 0 over "
                f"gloo: phase 14's bf16 GLU kernel run on {SP_MESH} with "
                "and without seq_shard; the f32 SP step at "
                f"{SP_F32_LAYERS} layers (GLU kernel, relu fused) against "
                "one rank; zamba2-7b decode over caches whose rows are cut "
                f"over {SP_DECODE_MESH[0]} data ranks against the whole "
                "cache; the dry run's train_4k with --seq-shard")
            run_seq_parallel(torch, dev, cells)
            time_rows(torch, dev, train_gemm_rows(
                torch, dev, 12, "sp tp 3 shard", F_=TP3_F,
                M=TRAIN["batch"] * SP_SEQ))
            time_rows(torch, dev, phase16_rows(torch, dev),
                      path="split-tf32")
            phase_done(16)
        if 17 in phases:
            log("phase 17: the tensor-parallel Mamba2 mixer, every rank on "
                f"card 0 over gloo: {SSM_TP_ARCH} ({SSM_TP_LAYERS} layers) "
                f"bf16 steps on {SSM_TP_MESH} with and without seq_shard "
                "beside one rank's, an f32 step each way against one "
                "rank's; zamba2-7b (2 layers) prefill and decode with h cut "
                "over 'model' (f32 against one rank's, then bf16); the dry "
                "run's mamba2-2.7b train_4k on (2, 4)")
            time_rows(torch, dev, run_ssm_tp(torch, dev))
            phase_done(17)
        if 18 in phases:
            log("phase 18: SASA's measuring autotuner (autotune_mlp_plan, "
                f"{AUTOTUNE_ITERS} calls a candidate) at the relu decode "
                "tick (bf16, f32), a 256-row prefill, a training step's "
                "4096 rows (s 0.5 and 0) and a tp-3 shard's; then "
                "examples/torch_quickstart.py and "
                "torch_sparse_gemm_demo.py on the card")
            run_autotune(torch, dev)
            phase_done(18)
        torch.cuda.synchronize()
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")
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
