"""Serving launcher for the port: continuous-batching prefill + decode.

    python -m repro_torch.launch.serve --arch smollm-135m [--reduced] \
        --requests 16 --mixed --batch-slots 8 --max-len 512 \
        --max-new 32 [--prompt-len 256] [--device cuda] \
        [--kv-block-size 16|0] [--attn-kernel gather|paged] \
        [--sparce] [--sparce-mode reference|kernel|fused] \
        [--sparce-autotune] [--sparce-gate-threshold TAU] \
        [--prefill-buckets 16,32,64|off] [--prefix-cache] \
        [--shared-prefix-len N] [--open-loop] [--arrival-rate 8] \
        [--slo-ttft-ticks 64] [--slo-itl-ticks 8] \
        [--mesh DP,TP --backend gloo|nccl] [--mesh-timeout 60]

``--arch`` names any of the eight serving archs of the port's registry:
the dense ``smollm-135m``, ``smollm-360m``, ``mistral-nemo-12b`` and
``qwen1.5-110b`` (GQA), the moe ``deepseek-v3-671b`` (MLA) and
``qwen2-moe-a2.7b`` (GQA, shared experts), the ssm ``mamba2-2.7b`` and
the hybrid ``zamba2-7b`` (mamba2 layers and one shared attention
block). Full configs are production-sized (DeepSeek-V3 holds 671 B
parameters), so on the CPU run them ``--reduced``. The flags of
``repro/launch/serve.py``. The KV layout is the paged
pool (``--kv-block-size`` rows a block) or, with ``--kv-block-size 0``,
the contiguous one; the ssm and hybrid archs always serve contiguous
caches. ``--attn-kernel`` defaults to ``paged`` (the paged decode
kernel) where the layout is paged and to ``gather`` everywhere else,
where the paged kernel is refused.
``--open-loop`` serves through ``AsyncServer``: a background engine
thread drains the live queue while this process submits the requests
with Poisson wall-clock gaps (``--arrival-rate``, mean requests per
second). ``--slo-ttft-ticks``/``--slo-itl-ticks`` set the latency SLO
(in decode ticks) the scheduler holds admission to; without them it
admits greedily.
``--prefix-cache`` shares identical prompt prefixes across requests as
read-only pool blocks (dense family); ``--shared-prefix-len N`` prepends
one seeded prefix of N tokens to every prompt (a shared system prompt),
the traffic it serves; ``--prefill-buckets`` sets the prefill buckets
(``off``: exact-length prefill).
The SparCE flags mean what the reference launcher's mean: ``--sparce``
swaps the MLP activation to relu before init (the paper's sparsity
source: a 2-matrix MLP without ``w_gate``); ``--sparce-gate-threshold``
keeps a gated-GLU arch's activation and skips gate tiles with every
``|act(g)| <= tau``; either one serves with per-slot tiles
(``block_m=1``, ``block_k=128``) in ``--sparce-mode`` (``fused``: the
fused MLP kernel, ``kernel``: the relu-bitmap and gated GEMM kernels,
``reference``: masked dense). Without either flag sparsity is off.
Weights are random, seeded by ``--seed``. ``--mixed`` draws per-request
prompt lengths from ``[prompt_len // 2, prompt_len]`` and budgets from
``[max_new // 4, max_new]``, as the reference launcher does. Prints the
metrics the reference launcher prints for these flags, plus the wall
clock decode rate on the device it ran on.
``--mesh DP,TP`` serves on a (data, model) mesh of DP x TP ranks
(``launch/mesh.py:spawn_mesh``; the paged layout of a dense, vlm or
audio arch): batch slots and the KV pool shard over DP data shards,
heads and FFN columns over TP model shards. Rank 0 runs the engine and
prints; the other ranks run its commands. ``--backend`` is the device
collectives' (``gloo``, the default, takes every rank on one device --
``--device cuda`` puts them all on card 0 -- or on the CPU; ``nccl``
takes one card per rank, rank r on card r); ``--mesh-timeout`` bounds
every collective's wait, in seconds. With ``--sparce`` under ``--mesh``
the f-tile halves from 128 until it divides the per-shard d_ff, as the
reference launcher's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-length workload: prompt lengths and "
                         "max_new budgets drawn per request")
    ap.add_argument("--sparce", action="store_true",
                    help="enable the SparCE path in serving MLPs (relu "
                         "MLP, skip-fraction metrics)")
    ap.add_argument("--sparce-mode", default="reference",
                    choices=("reference", "kernel", "fused"),
                    help="SparCE implementation: 'fused' = the fused MLP "
                         "kernel, 'kernel' = relu-bitmap + gated GEMM "
                         "kernels, 'reference' = masked dense")
    ap.add_argument("--sparce-autotune", action="store_true",
                    help="let the engine replan the MLP variant from the "
                         "measured (EMA) block sparsity")
    ap.add_argument("--sparce-gate-threshold", type=float, default=None,
                    help="gated-GLU dead-tile threshold tau: keep the "
                         "arch's GLU activation and skip gate tiles with "
                         "every |act(g)| <= tau (0 = exact all-zero test). "
                         "Implies --sparce.")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-pool-blocks", type=int, default=None)
    ap.add_argument("--prefill-buckets", default=None,
                    help="comma-separated prompt-length buckets (padded, "
                         "masked-tail prefill); default = powers of two "
                         "up to --max-len; 'off' = exact-length prefill")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share identical prompt prefixes across requests "
                         "as read-only KV pool blocks (chain-hashed "
                         "index, copy-on-write on a full-prompt match)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend a seeded common prefix of N tokens to "
                         "every request (a shared system prompt)")
    ap.add_argument("--attn-kernel", default=None,
                    choices=("gather", "paged"),
                    help="decode attention: 'paged' = the paged decode "
                         "kernel (needs the paged layout), 'gather' = the "
                         "full per-slot view; default 'paged' where the "
                         "layout is paged, else 'gather'")
    ap.add_argument("--open-loop", action="store_true",
                    help="serve via AsyncServer: a background engine "
                         "thread drains the live queue while requests "
                         "arrive with Poisson wall-clock gaps")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="--open-loop mean arrival rate, requests/second")
    ap.add_argument("--slo-ttft-ticks", type=float, default=None,
                    help="time-to-first-token budget in decode ticks; "
                         "enables SLO-aware admission scheduling")
    ap.add_argument("--slo-itl-ticks", type=float, default=None,
                    help="inter-token latency budget in decode ticks; "
                         "prefills only interleave when they fit this "
                         "gap (or TTFT forces them)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain kernel versions)")
    ap.add_argument("--mesh", default=None,
                    help="'DP,TP' serving mesh: shard batch slots + KV "
                         "pool over DP data shards and heads/FFN over TP "
                         "model shards (DP x TP ranks; needs "
                         "--kv-block-size > 0)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="--mesh device collectives: 'gloo' (every rank "
                         "on --device) or 'nccl' (rank r on card r)")
    ap.add_argument("--mesh-timeout", type=float, default=60.0,
                    help="--mesh: seconds any collective may wait")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    if args.mesh is None:
        return serve(args)
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.parallel.worker import serve_rank

    dp, tp = (int(x) for x in args.mesh.split(","))
    n = dp * tp
    if args.backend == "nccl":
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = ["cuda:0" if args.device == "cuda" else args.device] * n
    outs = spawn_mesh(serve_rank, (dp, tp), (serve, (args,), devices[0]),
                      device=devices, backend=args.backend,
                      timeout_s=args.mesh_timeout)
    return outs[0]


def serve(args):
    """Build the engine the flags describe and serve their requests (on
    rank 0 of the mesh with ``--mesh``); returns the completed requests."""

    from repro_torch.configs import get_config
    from repro_torch.core.sparse_ops import SparsityConfig
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.scheduler import SLOConfig
    from repro_torch.runtime.server import (
        AsyncServer, Request, ServeConfig, Server,
    )

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    sparsity = None
    if args.sparce or args.sparce_gate_threshold is not None:
        if (cfg.mlp_act in ("silu", "gelu")
                and args.sparce_gate_threshold is not None):
            tau = args.sparce_gate_threshold  # keep the gated GLU
        else:
            # The paper's sparsity source is a relu MLP; swap the act
            # before init (relu MLPs are 2-matrix, no w_gate).
            cfg = dataclasses.replace(cfg, mlp_act="relu")
            tau = 0.0
        # block_m=1: decode rows are slots, so each freed slot's MLP work
        # is individually skippable. Under --mesh the f-tile must divide
        # the per-shard d_ff (the engine refuses tilings that would break
        # exact skip-counter parity).
        block_k = 128
        if args.mesh is not None:
            tp = int(args.mesh.split(",")[1])
            while (cfg.d_ff // max(tp, 1)) % block_k:
                block_k //= 2
        sparsity = SparsityConfig(
            enabled=True, mode=args.sparce_mode, block_m=1, block_k=block_k,
            autotune=args.sparce_autotune, gate_threshold=tau)
    device = args.device
    if args.mesh is not None and device == "cuda":
        device = "cuda:0" if args.backend == "gloo" else "cuda"
    params = model_lib.init_params(cfg, seed=args.seed, device=device)
    attn_kernel = args.attn_kernel
    if attn_kernel is None:
        paged = (args.kv_block_size > 0
                 and cfg.family in model_lib.paged_families())
        attn_kernel = "paged" if paged else "gather"
    buckets = None
    if args.prefill_buckets is not None:
        buckets = (
            () if args.prefill_buckets.strip().lower() == "off"
            else tuple(int(b) for b in args.prefill_buckets.split(",")))
    slo = None
    if args.slo_ttft_ticks is not None or args.slo_itl_ticks is not None:
        defaults = SLOConfig()
        slo = SLOConfig(
            target_ttft_ticks=(args.slo_ttft_ticks
                               if args.slo_ttft_ticks is not None
                               else defaults.target_ttft_ticks),
            target_itl_ticks=(args.slo_itl_ticks
                              if args.slo_itl_ticks is not None
                              else defaults.target_itl_ticks))
    mesh = (None if args.mesh is None
            else tuple(int(x) for x in args.mesh.split(",")))
    serve_cfg = ServeConfig(
        batch_slots=args.batch_slots, max_len=args.max_len,
        temperature=args.temperature, eos_id=args.eos_id, seed=args.seed,
        sparsity=sparsity, kv_block_size=args.kv_block_size,
        kv_pool_blocks=args.kv_pool_blocks, prefill_buckets=buckets,
        attn_kernel=attn_kernel, prefix_cache=args.prefix_cache,
        slo=slo, mesh=mesh)

    rng = np.random.default_rng(args.seed)
    # One seeded prefix shared by every request, drawn first, as the
    # reference launcher draws it.
    # Audio prompts are (K, plen) codebook streams.
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    shared_prefix = (rng.integers(0, cfg.vocab_size,
                                  lead + (args.shared_prefix_len,))
                     if args.shared_prefix_len > 0 else None)
    reqs = []
    for i in range(args.requests):
        plen, max_new = args.prompt_len, args.max_new
        if args.mixed:
            plen = int(rng.integers(max(1, args.prompt_len // 2),
                                    args.prompt_len + 1))
            max_new = int(rng.integers(max(1, args.max_new // 4),
                                       args.max_new + 1))
        prompt = rng.integers(0, cfg.vocab_size, lead + (plen,))
        if shared_prefix is not None:
            prompt = np.concatenate([shared_prefix, prompt], axis=-1)
        reqs.append(Request(uid=i, prompt=prompt, max_new=max_new))

    if args.open_loop:
        # Live queue: Poisson-spaced submissions against the background
        # engine thread, then a drain and a shutdown.
        asrv = AsyncServer(cfg, params, serve_cfg, device=device)
        gaps = rng.exponential(1.0 / max(args.arrival_rate, 1e-6),
                               size=len(reqs))
        t0 = time.perf_counter()
        for r, gap in zip(reqs, gaps):
            time.sleep(float(gap))
            asrv.submit(r.prompt, max_new=r.max_new, eos_id=r.eos_id,
                        uid=r.uid)
        done = asrv.drain()
        asrv.shutdown()
        dt = time.perf_counter() - t0
        srv = asrv.server
    else:
        srv = Server(cfg, params, serve_cfg, device=device)
        t0 = time.perf_counter()
        done = srv.generate(reqs)
        dt = time.perf_counter() - t0
    m = srv.metrics
    tok = m.decode_tokens
    print(f"served {len(done)} requests, {tok} decode tokens in "
          f"{m.ticks} ticks, {dt:.2f}s ({tok / max(dt, 1e-9):.1f} tok/s) "
          f"on {srv.device}")
    if m.mesh_data or m.mesh_model:
        from repro_torch.parallel import collectives
        c = collectives.stats()
        print(f"  SPMD mesh: data={int(m.mesh_data)} x "
              f"model={int(m.mesh_model)} "
              f"(slots+KV pool sharded over data, heads/FFN over model; "
              f"skip stats below are summed across shards); rank 0's "
              f"collectives: {sum(c['counts'].values())} calls, "
              f"{c['total'] / 1e6:.2f} MB, "
              f"{sum(c['seconds'].values()):.2f}s")
    occ = tok / max(1, m.ticks * args.batch_slots)
    print(f"  slot occupancy {occ:.2f}, prefill {m.prefill_tokens} tok "
          f"/ {m.prefill_s:.2f}s, decode {m.decode_s:.2f}s "
          f"({tok / max(m.decode_s, 1e-9):.1f} decode tok/s, "
          f"{1e3 * m.decode_s / max(m.ticks, 1):.2f} ms/tick)")
    if m.total_tile_dots:
        print(f"  SparCE mlp_skip_fraction={m.mlp_skip_fraction:.3f} "
              f"({m.skipped_tile_dots:.0f}/{m.total_tile_dots:.0f} "
              f"tile-dots)")
    if m.kv_paged:
        print(f"  paged KV: {int(m.kv_pool_blocks)} blocks x "
              f"{int(m.kv_block_size)} rows, peak in use "
              f"{int(m.kv_blocks_peak_in_use)} "
              f"(occupancy {m.kv_pool_peak_occupancy:.2f}, internal "
              f"frag {m.kv_internal_frag:.2f})")
        sf = m.kv_bytes_saved_frac
        saved = (f"{sf:.1%} saved" if sf >= 0
                 else f"{-sf:.1%} block-rounding overhead; undersize with "
                      "--kv-pool-blocks to share memory")
        print(f"  KV reserved (modeled) {m.kv_bytes_reserved/1e6:.2f} MB "
              f"paged vs {m.kv_bytes_reserved_contiguous/1e6:.2f} MB "
              f"contiguous ({saved}, "
              f"{m.kv_reserved_bytes_per_token/1e3:.1f} KB/token); "
              f"{int(m.prefill_traces)} prefill bucket shapes")
        if m.attn_blocks_total:
            realized = ("saved" if m.attn_kernel_paged
                        else "skippable (run --attn-kernel paged)")
            print(f"  decode attn: {int(m.attn_blocks_fetched)}/"
                  f"{int(m.attn_blocks_total)} pool-block fetches "
                  f"(skip {m.attn_block_skip_fraction:.1%}); "
                  f"{(m.attn_bytes_gather - m.attn_bytes_paged)/1e6:.2f}"
                  f" MB (modeled) {realized} vs full-view gather")
    if m.prefix_cache_enabled:
        print(f"  prefix cache: {int(m.prefix_hits)}/"
              f"{int(m.prefix_lookups)} admissions hit "
              f"(rate {m.prefix_hit_rate:.1%}), "
              f"{int(m.prefix_matched_tokens)} prompt tokens served from "
              f"cache, {int(m.prefix_blocks_shared)} blocks shared, "
              f"{int(m.prefix_cow_forks)} CoW forks, "
              f"{int(m.prefix_evicted_blocks)} evicted")
        print(f"  prefix savings (modeled): "
              f"{m.prefill_ticks_saved:.2f}/{m.prefill_ticks_nocache:.2f} "
              f"prefill ticks ({m.prefill_ticks_saved_frac:.1%}), "
              f"{m.prefill_flops_saved/1e9:.2f} GFLOP of prefill skipped")
    if args.open_loop or slo is not None:
        print(f"  queue: depth peak {int(m.queue_depth_peak)}, "
              f"admission {int(m.sched_admitted)} admitted / "
              f"{int(m.sched_deferred)} deferred / "
              f"{int(m.sched_forced)} TTFT-forced; "
              f"prefill tick share {m.prefill_tick_share:.2f}")
        print(f"  latency (virtual ticks): TTFT p50/p99 "
              f"{m.ttft_ticks_p50:.1f}/{m.ttft_ticks_p99:.1f}, "
              f"ITL p50/p99 "
              f"{m.itl_ticks_p50:.1f}/{m.itl_ticks_p99:.1f}; "
              f"SLO violations ttft={int(m.slo_ttft_violations)} "
              f"itl={int(m.slo_itl_violations)}")
        print(f"  latency (wall clock): TTFT p50/p99 "
              f"{m.ttft_s_p50 * 1e3:.1f}/{m.ttft_s_p99 * 1e3:.1f} ms")
    for r in done[:3]:
        s = r.stats
        print(f"  req {r.uid}: ttft={s['ttft_s']*1e3:.1f}ms "
              f"latency={s['latency_s']*1e3:.1f}ms tokens={int(s['tokens'])} "
              f"out={list(map(int, np.asarray(r.out).flat[:8]))}")
    return done


if __name__ == "__main__":
    main()
