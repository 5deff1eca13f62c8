"""Serving launcher for the port: continuous-batching prefill + decode.

    python -m repro_torch.launch.serve --arch smollm-135m [--reduced] \
        --requests 16 --mixed --batch-slots 8 --max-len 512 \
        --max-new 32 [--prompt-len 256] [--device cuda] \
        [--sparce] [--sparce-mode reference|kernel|fused] \
        [--sparce-autotune] [--sparce-gate-threshold TAU]

The subset of ``repro/launch/serve.py``'s flags that the port supports
(no ``--mesh``, prefix cache, SLO or open-loop flags), over the paged KV
pool with the paged decode kernel by default (``--attn-kernel paged``).
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
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def main(argv=None):
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
    ap.add_argument("--attn-kernel", default="paged",
                    choices=("gather", "paged"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain kernel versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.sparse_ops import SparsityConfig
    from repro_torch.models import model as model_lib
    from repro_torch.runtime.server import Request, ServeConfig, Server

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
        # is individually skippable.
        sparsity = SparsityConfig(
            enabled=True, mode=args.sparce_mode, block_m=1, block_k=128,
            autotune=args.sparce_autotune, gate_threshold=tau)
    params = model_lib.init_params(cfg, seed=args.seed, device=args.device)
    serve_cfg = ServeConfig(
        batch_slots=args.batch_slots, max_len=args.max_len,
        temperature=args.temperature, eos_id=args.eos_id, seed=args.seed,
        sparsity=sparsity, kv_block_size=args.kv_block_size,
        kv_pool_blocks=args.kv_pool_blocks, attn_kernel=args.attn_kernel)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen, max_new = args.prompt_len, args.max_new
        if args.mixed:
            plen = int(rng.integers(max(1, args.prompt_len // 2),
                                    args.prompt_len + 1))
            max_new = int(rng.integers(max(1, args.max_new // 4),
                                       args.max_new + 1))
        reqs.append(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                       plen),
                            max_new=max_new))

    srv = Server(cfg, params, serve_cfg, device=args.device)
    t0 = time.perf_counter()
    done = srv.generate(reqs)
    dt = time.perf_counter() - t0
    m = srv.metrics
    tok = m.decode_tokens
    print(f"served {len(done)} requests, {tok} decode tokens in "
          f"{m.ticks} ticks, {dt:.2f}s ({tok / max(dt, 1e-9):.1f} tok/s) "
          f"on {srv.device}")
    occ = tok / max(1, m.ticks * args.batch_slots)
    print(f"  slot occupancy {occ:.2f}, prefill {m.prefill_tokens} tok "
          f"/ {m.prefill_s:.2f}s, decode {m.decode_s:.2f}s "
          f"({tok / max(m.decode_s, 1e-9):.1f} decode tok/s, "
          f"{1e3 * m.decode_s / max(m.ticks, 1):.2f} ms/tick)")
    if m.total_tile_dots:
        print(f"  SparCE mlp_skip_fraction={m.mlp_skip_fraction:.3f} "
              f"({m.skipped_tile_dots:.0f}/{m.total_tile_dots:.0f} "
              f"tile-dots)")
    print(f"  paged KV: {int(m.kv_pool_blocks)} blocks x "
          f"{int(m.kv_block_size)} rows, peak in use "
          f"{int(m.kv_blocks_peak_in_use)} "
          f"(occupancy {m.kv_pool_peak_occupancy:.2f}, internal "
          f"frag {m.kv_internal_frag:.2f})")
    sf = m.kv_bytes_saved_frac
    saved = (f"{sf:.1%} saved" if sf >= 0
             else f"{-sf:.1%} block-rounding overhead; undersize with "
                  "--kv-pool-blocks to share memory")
    print(f"  KV reserved (modeled) {m.kv_bytes_reserved/1e6:.2f} MB paged "
          f"vs {m.kv_bytes_reserved_contiguous/1e6:.2f} MB contiguous "
          f"({saved}, {m.kv_reserved_bytes_per_token/1e3:.1f} KB/token); "
          f"{int(m.prefill_traces)} prefill bucket shapes")
    if m.attn_blocks_total:
        realized = ("saved" if m.attn_kernel_paged
                    else "skippable (run --attn-kernel paged)")
        print(f"  decode attn: {int(m.attn_blocks_fetched)}/"
              f"{int(m.attn_blocks_total)} pool-block fetches "
              f"(skip {m.attn_block_skip_fraction:.1%}); "
              f"{(m.attn_bytes_gather - m.attn_bytes_paged)/1e6:.2f}"
              f" MB (modeled) {realized} vs full-view gather")
    for r in done[:3]:
        s = r.stats
        print(f"  req {r.uid}: ttft={s['ttft_s']*1e3:.1f}ms "
              f"latency={s['latency_s']*1e3:.1f}ms tokens={int(s['tokens'])} "
              f"out={list(map(int, np.asarray(r.out).flat[:8]))}")
    return done


if __name__ == "__main__":
    main()
