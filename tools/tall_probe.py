"""The tall paths of the gated GEMM and the fused relu MLP on one GPU, at
the training shapes of PERF.md's rows 3b, 3d and 5b-5f, against their
plain versions and beside the library's call.

    python3 tools/tall_probe.py [--src DIR] [--fixed | --plans]
                                [--iters N]

Builds ``sparce_gemm`` and ``sparce_mlp``, prints the tall kernels'
registers and spills (ptxas), then for each shape: the wrapper's plan,
y within 1e-2 of max|y| of the plain version (bf16 rounding after f32
sums in another order), the bits exactly (MLP), a second call equal bit
for bit, NaN in every gated x tile (GEMM) or in the w_out rows of every
stripe dead in all row tiles (MLP) never reaching y; and the kernel's
and the library call's device ms by
``chip_smoke.device_time_ms`` (profiler) and ``graph_time_ms`` (a
replayed CUDA graph), in turns (library, kernel, kernel, library).
``--fixed`` times, instead, what a CTA costs beside its products: the
GEMM at the FP and BP shapes with every tile gated (no load, no
product) and every tile live, and at 4 CTAs of one 64-deep stage.
``--plans`` times the GEMM at every column tile and chunk count the
plan could pick, where it splits K or leaves the card short.
``--dump FILE`` saves the first designs' outputs at the shapes that keep
them (decode, prefill, f32, the other gates) on seeded inputs, to hold
two trees' files equal bit for bit.
``--src DIR`` imports the port from another tree (e.g. a ``git archive``
of the parent under ``build/``), so two trees run in turns in one call.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
_SRC = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv
        else os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.abspath(_SRC))
from chip_smoke import device_time_ms, graph_time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import sparce_gemm as sg  # noqa: E402
from repro_torch.kernels import sparce_mlp as sm  # noqa: E402

TALL_GEMM = ("tall_gemm_kernel", "chunk_reduce_kernel")
TALL_MLP = ("mlp_tall_kernel",)
REL = 1e-2

# (row, what, M, K, N, bm, bk): a training step's down-projection GEMMs.
GEMMS = (
    ("5b", "BP", 4096, 576, 1536, 64, 128),
    ("5c", "WG", 1536, 4096, 576, 128, 64),
    ("FP", "FP", 4096, 1536, 576, 64, 128),
    ("5d", "FP", 4096, 512, 576, 64, 128),
    ("5d", "BP", 4096, 576, 512, 64, 128),
    ("5d", "WG", 512, 4096, 576, 128, 64),
    ("5e", "FP", 1024, 1536, 576, 64, 128),
    ("5e", "BP", 1024, 576, 1536, 64, 128),
    ("5e", "WG", 1536, 1024, 576, 128, 64),
    ("5f", "FP", 4608, 512, 576, 64, 128),
    ("5f", "BP", 4608, 576, 512, 64, 128),
    ("5f", "WG", 512, 4608, 576, 128, 64),
    ("ragged", "-", 1100, 600, 1000, 64, 128),
)
# (row, M, K, F, N): the fused relu MLP at (64, 128) tiles.
MLPS = (
    ("3b", 4096, 576, 1536, 576),
    ("3d", 2048, 576, 1536, 576),
    ("tp-3", 4608, 576, 512, 576),
    ("ragged", 1100, 568, 1000, 600),
)


def gemm_operands(M, K, N, bm, bk, seed):
    """x with 30% of its (bm, bk) tiles zero, w at init scale; the bits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    gm, gk = -(-M // bm), -(-K // bk)
    dead = rng.random((gm, gk)) < 0.3
    for i, j in zip(*np.nonzero(dead)):
        x[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = 0.0
    w = rng.standard_normal((K, N), dtype=np.float32) / np.sqrt(K)
    t = lambda a: torch.from_numpy(a).cuda().to(torch.bfloat16)  # noqa
    return t(x), t(w), torch.from_numpy(dead.astype(np.int32)).cuda()


def mlp_operands(M, K, F, N, seed, bm=64, bf=128):
    """chip_smoke.mlp_case's operands: nonnegative x with the row tile
    of row M // 2 zero, w_in's stripe 2 negative (dead in every tile)."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((M, K), dtype=np.float32))
    t = (M // 2) // bm
    x[t * bm:(t + 1) * bm] = 0.0
    wi = rng.standard_normal((K, F), dtype=np.float32) / np.sqrt(K)
    wi[:, 2 * bf:3 * bf] = -np.abs(wi[:, 2 * bf:3 * bf])
    wo = rng.standard_normal((F, N), dtype=np.float32) / np.sqrt(F)
    c = lambda a: torch.from_numpy(a).cuda().to(torch.bfloat16)  # noqa
    return c(x), c(wi), c(wo)


def close(name, got, want):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= REL * max(scale, 1e-30)
    print(f"  {name}: max_abs_err {err:.3e} of max|want| {scale:.3e} "
          f"({err / max(scale, 1e-30):.2e}, limit {REL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def check_gemm(row, what, M, K, N, bm, bk):
    x, w, bits = gemm_operands(M, K, N, bm, bk, seed=M + K + N)
    kw = dict(block_m=bm, block_k=bk, block_n=128)
    plan = sg.tall_plan(M, K, N, block_m=bm, block_k=bk,
                        dtype=torch.bfloat16)
    n0 = sg.sparce_gemm_gated.tall_launches
    y = sg.sparce_gemm_gated(x, w, bits, **kw)
    want = sg.sparce_gemm_gated_plain(x, w, bits, **kw)
    torch.cuda.synchronize()
    name = f"gemm {row} {what} {M}x{K} @ {K}x{N} tiles ({bm}, {bk}) plan {plan}"
    ok = close(name, y, want)
    ok &= sg.sparce_gemm_gated.tall_launches == n0 + 1
    y1 = sg.sparce_gemm_gated(x, w, bits, **kw)
    yc = sg.sparce_gemm_compacted(x, w, bits, **kw)
    x2 = x.clone()
    for i, j in zip(*np.nonzero(bits.cpu().numpy())):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")
    y2 = sg.sparce_gemm_gated(x2, w, bits, **kw)
    torch.cuda.synchronize()
    same = torch.equal(y1.view(torch.int16), y.view(torch.int16))
    comp = torch.equal(yc.view(torch.int16), y.view(torch.int16))
    pois = bool(torch.isfinite(y2).all()) and torch.equal(y2, y)
    print(f"    second call bit-equal {same}; compacted bit-equal {comp}; "
          f"NaN poison kept out {pois}", flush=True)
    return ok and same and comp and pois, (x, w, bits, kw)


def check_mlp(row, M, K, F, N, act):
    x, wi, wo = mlp_operands(M, K, F, N, seed=M + F)
    kw = dict(block_m=64, block_f=128, act=act)
    n0 = sm.sparce_mlp_fused.tall_launches
    y, bits = sm.sparce_mlp_fused(x, wi, wo, **kw)
    y0, bits0 = sm.sparce_mlp_fused_plain(x, wi, wo, **kw)
    torch.cuda.synchronize()
    name = f"mlp {row} {act} {M}x{K} F {F} N {N}"
    ok = close(name, y, y0) and sm.sparce_mlp_fused.tall_launches == n0 + 1
    bits_ok = torch.equal(bits, bits0)
    y1, bits1 = sm.sparce_mlp_fused(x, wi, wo, **kw)
    dead_f = bits.bool().all(dim=0).nonzero().flatten().tolist()
    wo2 = wo.clone()
    for f in dead_f:
        wo2[f * 128:(f + 1) * 128] = float("nan")
    y2, bits2 = sm.sparce_mlp_fused(x, wi, wo2, **kw)
    torch.cuda.synchronize()
    same = (torch.equal(y1.view(torch.int16), y.view(torch.int16))
            and torch.equal(bits1, bits))
    pois = (bool(torch.isfinite(y2).all()) and torch.equal(y2, y)
            and torch.equal(bits2, bits))
    print(f"    bits equal {bits_ok} ({int(bits.sum())} of {bits.numel()} "
          f"dead; dead stripes {dead_f}); second call bit-equal {same}; "
          f"NaN poison kept out {pois}", flush=True)
    return ok and bits_ok and same and pois, (x, wi, wo, kw)


def times(run, library, names, iters):
    """(kernel profiler ms, kernel graph ms, library profiler ms, library
    graph ms), in turns: library, kernel, kernel, library."""
    lib = [device_time_ms(library, iters=iters)[0]]
    ker = [device_time_ms(run, iters=iters, names=names)[0]]
    ker.append(device_time_ms(run, iters=iters, names=names)[0])
    lib.append(device_time_ms(library, iters=iters)[0])
    kg, lg = graph_time_ms(run), graph_time_ms(library)
    return ker, kg, lib, lg


def fixed_costs(iters):
    """The GEMM's device ms where a CTA does little besides its prologue
    and epilogue: every tile gated, every tile live, 4 CTAs."""
    cases = (("FP all gated", 4096, 1536, 576, 64, 128, 1),
             ("FP all live", 4096, 1536, 576, 64, 128, 0),
             ("BP all gated", 4096, 576, 1536, 64, 128, 1),
             ("BP all live", 4096, 576, 1536, 64, 128, 0),
             ("4 CTAs, one stage", 512, 64, 128, 64, 64, 0),
             ("4 CTAs, 16 stages", 512, 1024, 128, 64, 64, 0),
             ("96 CTAs, one stage", 4096, 64, 576, 64, 64, 0))
    for label, M, K, N, bm, bk, bit in cases:
        x, w, _ = gemm_operands(M, K, N, bm, bk, seed=1)
        bits = torch.full((-(-M // bm), -(-K // bk)), bit, dtype=torch.int32,
                          device="cuda")
        kw = dict(block_m=bm, block_k=bk, block_n=128)
        run = lambda: sg.sparce_gemm_gated(x, w, bits, **kw)  # noqa: E731
        ker = device_time_ms(run, iters=iters, names=TALL_GEMM)[0]
        lib = device_time_ms(lambda: x @ w, iters=iters)[0]
        print(f"  fixed {label} {M}x{K} @ {K}x{N} plan "
              f"{sg.tall_plan(M, K, N, block_m=bm, block_k=bk, dtype=torch.bfloat16)}: "
              f"kernel {ker:.4f} ms profiler, {graph_time_ms(run):.4f} "
              f"graph; library {lib:.4f}", flush=True)


def plan_sweep(iters):
    """The gated GEMM's device ms at each (column tile, chunks) the plan
    could pick, at the shapes where the planner splits K or leaves the
    card short, beside the plan it does pick."""
    shapes = (("5c WG", 1536, 4096, 576, 128, 64),
              ("5d WG", 512, 4096, 576, 128, 64),
              ("5e FP", 1024, 1536, 576, 64, 128),
              ("5e WG", 1536, 1024, 576, 128, 64),
              ("5e BP", 1024, 576, 1536, 64, 128),
              ("FP", 4096, 1536, 576, 64, 128))
    pick = sg.tall_plan
    for label, M, K, N, bm, bk in shapes:
        x, w, bits = gemm_operands(M, K, N, bm, bk, seed=M + K + N)
        kw = dict(block_m=bm, block_k=bk, block_n=128)
        chosen = pick(M, K, N, block_m=bm, block_k=bk, dtype=torch.bfloat16)
        gk = -(-K // bk)
        out = []
        for bn in sg.TALL_BN:
            for c in (1, 2, 3, 4, 6, 8):
                s_ = -(-gk // c)
                if -(-gk // s_) != c:
                    continue
                sg.tall_plan = lambda *a, _p=(bn, s_), **k: _p  # noqa
                run = lambda: sg.sparce_gemm_gated(x, w, bits, **kw)  # noqa
                out.append((bn, c, device_time_ms(run, iters=iters,
                                                  names=TALL_GEMM)[0]))
        sg.tall_plan = pick
        print(f"  plans {label} {M}x{K} @ {K}x{N}: chosen {chosen}; "
              + ", ".join(f"({bn}, {c} chunks) {ms:.4f}"
                          for bn, c, ms in out), flush=True)


def decode_outputs(path):
    """The first designs' outputs at the shapes that keep them (decode,
    the 256-row prefill, f32, the rhs and two-sided gates, AlexNet's
    tiles), on seeded inputs, saved to ``path``: two trees' files equal
    bit for bit show the tall path left those kernels' results alone."""
    from repro_torch.kernels import sparce_glu_mlp as sgm
    rng = np.random.default_rng(0)
    out = {}

    def t(*shape, dtype=torch.bfloat16, scale=1.0, nonneg=False):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(np.abs(a) if nonneg else a).to("cuda", dtype)
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for M, bm, gate in ((8, 1, "lhs"), (256, 1, "lhs"), (256, 64, "lhs"),
                            (8, 1, "rhs")):
            x, w = t(M, 1536, dtype=dtype), t(1536, 576, dtype=dtype,
                                              scale=1536 ** -0.5)
            grid = sg.bit_grid(M, 1536, 576, block_m=bm, block_k=128,
                               block_n=128, gate=gate)
            bits = torch.from_numpy((rng.random(grid) < 0.4).astype(
                np.int32)).cuda()
            out[f"gated {tag} {M} {bm} {gate}"] = sg.sparce_gemm_gated(
                x, w, bits, block_m=bm, block_k=128, block_n=128, gate=gate)
        x, w = t(169, 3456, dtype=dtype), t(3456, 384, dtype=dtype,
                                            scale=3456 ** -0.5)
        lb = torch.from_numpy((rng.random((22, 27)) < 0.6).astype(
            np.int32)).cuda()
        rb_ = torch.from_numpy((rng.random((27, 2)) < 0.3).astype(
            np.int32)).cuda()
        out[f"compacted {tag}"] = sg.sparce_gemm_compacted(
            x, w, lb, block_m=8, block_k=128, block_n=256)
        out[f"both {tag}"] = sg.sparce_gemm_gated_both(
            x, w, lb, rb_, block_m=8, block_k=128, block_n=256)
        for M, bm, bf in ((8, 1, 128), (256, 1, 128), (256, 256, 512),
                          (4096, 64, 128) if dtype == torch.float32
                          else (256, 64, 128)):
            x = t(M, 576, dtype=dtype, nonneg=True)
            wi = t(576, 1536, dtype=dtype, scale=576 ** -0.5)
            wo = t(1536, 576, dtype=dtype, scale=1536 ** -0.5)
            y, b = sm.sparce_mlp_fused(x, wi, wo, block_m=bm, block_f=bf)
            out[f"mlp {tag} {M} {bm} {bf}"] = y
            out[f"mlp bits {tag} {M} {bm} {bf}"] = b
        x = t(8, 576, dtype=dtype)
        wg, wi = (t(576, 1536, dtype=dtype, scale=576 ** -0.5)
                  for _ in range(2))
        wo = t(1536, 576, dtype=dtype, scale=1536 ** -0.5)
        y, b = sgm.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=8,
                                        block_f=128)
        out[f"glu {tag}"], out[f"glu bits {tag}"] = y, b
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"  saved {len(out)} outputs of the first designs to {path}")


def resources():
    for name in ("sparce_gemm", "sparce_mlp"):
        entry = None
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif entry and ("tall" in entry) and (
                    "registers" in line or "spill" in line
                    or "smem" in line):
                print(f"  {name}: {entry}: {line.strip()}")
            elif "warning" in line.lower() or "error" in line.lower():
                print(f"  {name}: {line.strip()}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixed", action="store_true")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--src", default=None)
    args = ap.parse_args(argv)
    assert torch.cuda.is_available(), "needs a CUDA device"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    print("source:", os.path.dirname(os.path.dirname(sg.__file__)))
    if args.dump:
        decode_outputs(args.dump)
        return 0
    _build.build(("sparce_gemm", "sparce_mlp"))
    resources()
    if args.fixed:
        fixed_costs(args.iters)
        return 0
    if args.plans:
        plan_sweep(args.iters)
        return 0
    failed = []
    for row, what, M, K, N, bm, bk in GEMMS:
        ok, (x, w, bits, kw) = check_gemm(row, what, M, K, N, bm, bk)
        if not ok:
            failed.append(f"gemm {row} {what}")
            continue
        ker, kg, lib, lg = times(
            lambda: sg.sparce_gemm_gated(x, w, bits, **kw),
            lambda: x @ w, TALL_GEMM, args.iters)
        print(f"    device ms: kernel {ker[0]:.4f} / {ker[1]:.4f} profiler, "
              f"{kg:.4f} graph; library {lib[0]:.4f} / {lib[1]:.4f} "
              f"profiler, {lg:.4f} graph", flush=True)
    for row, M, K, F, N in MLPS:
        for act in ("relu", "relu2"):
            ok, (x, wi, wo, kw) = check_mlp(row, M, K, F, N, act)
            if not ok:
                failed.append(f"mlp {row} {act}")
                continue
            if act == "relu2":
                continue
            ker, kg, lib, lg = times(
                lambda: sm.sparce_mlp_fused(x, wi, wo, **kw),
                lambda: torch.relu(x @ wi) @ wo, TALL_MLP, args.iters)
            print(f"    device ms: kernel {ker[0]:.4f} / {ker[1]:.4f} "
                  f"profiler, {kg:.4f} graph; library {lib[0]:.4f} / "
                  f"{lib[1]:.4f} profiler, {lg:.4f} graph", flush=True)
    print("failed:", failed if failed else "none")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
