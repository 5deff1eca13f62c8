"""The paper's evaluation on the port: the rows of the reference's figure
scripts (``benchmarks/fig{4,14,16,17,18}_*.py``) and of its GEMM examples
(``examples/sparse_gemm_demo.py``, part 1 of ``examples/quickstart.py``).

    python -m repro_torch.launch.figures --figs 4,14,16,17,18,demo \\
        [--device cuda|cpu] [--seed N]

Prints CSV rows ``name,us,derived`` as the reference's scripts do. ``us``
is the host time per call on the device the run used, around calls that
end in a device sync on the card. The ``derived`` fields carry the
reference's keys (the examples, which print prose, get rows of their
own named ``demo/...`` and ``quickstart/...``). Rows that depend on no
random draw -- fig14, fig4's ``redundant_word`` and ``fig5`` rows,
fig16's GPP fields and fig17's ``gpp_*`` rows -- equal the reference's
text. The others take their operands from :func:`sprf.random_sparse` and
normal draws of one torch generator seeded with ``--seed``: the
reference's zero counts and cluster geometry, not its numbers (it draws
with its own framework's keys). Each such row is computed by a helper
that takes its operands as tensors, so a test can feed both packages the
same arrays. Every skipping GEMM a row runs is held against the masked
oracle (``ref.sparce_gemm_ref`` with the same bits), and the run stops
with an error where they disagree.

``tpu_*``, ``modeled_*``, ``app_reduction``, ``instr_*`` and ``dcache_*``
fields are the reference cost model's accounting (the paper's simulated
core, the roofline of the accelerator the reference was written for;
``core/cost_model.py``), not measurements of this card. The run uses
the card unless ``--device cpu`` is given; on the CPU every kernel runs
its plain version. Training (quickstart part 2) is not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.paper_alexnet import (
    ALEXNET_GEMMS, BENCH_SPARSITY, DEEPCOMP_WEIGHT_SPARSITY,
)
from repro_torch.core import cost_model as cm
from repro_torch.core import sasa, sprf
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import sparce_gemm as sg

FIG17_MKN = (169, 3456, 384)  # the paper's Fig. 17 matrices
FIG18_MKN = (256, 3456, 384)
DEMO_MKN = (256, 3456, 384)  # the demo's Fig. 17 inner dims, padded M
DEMO_BLOCKS = (8, 128, 128)
DEMO_SPARSITY = 0.7
QUICKSTART_MKN = (512, 2048, 512)

Row = Tuple[str, float, str]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable, dev: torch.device, *, iters: int = 3):
    """(last result, microseconds per call): host clock around ``iters``
    calls after one warm-up call, synchronized with the card before and
    after (the reference's ``benchmarks/common.timed`` plus the sync)."""
    out = fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) / iters * 1e6


# Every skipping GEMM's output against the masked oracle: f32 sums over up
# to 3456 terms of unit-normal products in another order than the
# oracle's dense product.
GEMM_ATOL, GEMM_RTOL = 1e-3, 1e-4


def timed_gemm(name: str, fn: Callable, x: torch.Tensor, w: torch.Tensor,
               dev, *, block_m: int, block_k: int, block_n: int, lhs=None,
               rhs=None, iters: int = 3):
    """:func:`timed` for a skipping GEMM, whose last output is then held
    against :func:`ref.sparce_gemm_ref` with the same bits (lhs over x's
    tiles, rhs over w's): raises when they disagree."""
    y, us = timed(fn, dev, iters=iters)
    want = kref.sparce_gemm_ref(x, w, bits_lhs=lhs, bits_rhs=rhs,
                                block_m=block_m, block_k=block_k,
                                block_n=block_n)
    if not torch.allclose(y, want, atol=GEMM_ATOL, rtol=GEMM_RTOL):
        err = float((y - want).abs().max())
        raise AssertionError(f"{name}: differs from the masked oracle by "
                             f"{err:.3e}")
    return y, us


def format_row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.1f},{derived}"


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _cluster_elems(cluster) -> int:
    return 1 if cluster is None else cluster[0] * cluster[1]


# ------------------------------------------------------------------ fig 4
def fig4_tile_harvest(x: torch.Tensor, cluster, dev) -> Tuple[float, str]:
    """The tile-level harvest of conv4's features ``x`` at the planner's
    blocks."""
    layer = ALEXNET_GEMMS[3]  # conv4: 169x3456x384
    plan = sasa.plan_matmul(layer.m, layer.k, layer.n,
                            lhs_sparsity=layer.act_sparsity,
                            lhs_cluster=_cluster_elems(cluster))
    bmp, us = timed(lambda: sprf.compute_bitmap(
        x, (plan.block_m, plan.block_k)), dev)
    return us, (f"word={layer.act_sparsity:.2f};"
                f"tile={float(bmp.sparsity()):.3f};"
                f"block={plan.block_m}x{plan.block_k}")


def fig4(dev, gen) -> List[Row]:
    """Paper Fig. 4/5: the MAC fraction dynamic feature sparsity makes
    redundant, per benchmark, across inputs, and at tile level."""
    rows, fracs = [], []
    for bench, s in BENCH_SPARSITY.items():
        rep, us = timed(lambda: sasa.analyze_network(ALEXNET_GEMMS,
                                                     act_cluster=8), dev)
        # the alexnet layer profile scaled to the benchmark's sparsity
        word = min(0.95, rep["word_redundant_frac"] * (s / 0.36))
        fracs.append(word)
        rows.append((f"fig4/redundant_word/{bench}", us,
                     f"frac={word:.3f};paper_band=0.25-0.60"))
    rows.append(("fig4/redundant_word/average", 0.0,
                 f"frac={np.mean(fracs):.3f};paper_avg=0.451"))
    # variation across inputs (paper Fig. 5: ~14% spread, min 28%)
    rng = np.random.default_rng(0)
    per_input = np.clip(0.36 + rng.normal(0, 0.024, 1000), 0.25, 0.55)
    rows.append(("fig5/alexnet_inputs", 0.0,
                 f"min={per_input.min():.3f};max={per_input.max():.3f};"
                 f"spread={per_input.max()-per_input.min():.3f};"
                 "paper_spread=0.14"))
    layer = ALEXNET_GEMMS[3]
    for cluster, label in ((None, "iid"), ((8, 128), "row-clustered")):
        x = sprf.random_sparse(gen, (layer.m, layer.k), layer.act_sparsity,
                               cluster=cluster)
        rows.append((f"fig4/tile_harvest/conv4/{label}",
                     *fig4_tile_harvest(x, cluster, dev)))
    return rows


# ----------------------------------------------------------------- fig 14
def bench_layers(bench: str):
    """The AlexNet layer profile scaled to ``bench``'s average sparsity:
    [(layer, act_sparsity, weight_sparsity)]."""
    scale = BENCH_SPARSITY[bench] / 0.36
    layers = []
    for layer in ALEXNET_GEMMS:
        act = min(0.9, layer.act_sparsity * scale)
        w = (DEEPCOMP_WEIGHT_SPARSITY.get(layer.name, 0.0)
             if bench == "deepcomp-alexnet" else 0.0)
        layers.append((layer, act, w))
    return layers


def bench_plan(layer, act: float, w: float) -> sasa.SkipPlan:
    """A layer's plan as the paper's Fig. 14 plans it: features in
    8 x 128 clusters, pruned weights in 64 x 128."""
    return sasa.plan_matmul(layer.m, layer.k, layer.n, lhs_sparsity=act,
                            rhs_sparsity=w, lhs_cluster=8 * 128,
                            rhs_cluster=64 * 128)


def fig14(dev, gen) -> List[Row]:
    """Paper Fig. 14/15: application-level execution-time reduction on
    both GPP baselines, the training phases, and the tile-level figure."""
    del gen  # no random draw
    paper_inference = {
        "cifar10": (0.31, 0.15), "alexnet": (0.223, 0.12),
        "vgg16": (0.28, 0.13), "resnet50": (0.24, 0.10),
        "googlenet": (0.19, 0.08), "deepcomp-alexnet": (0.31, 0.15),
    }
    rows = []
    for gpp, label in ((cm.SCALAR_GPP, "scalar"), (cm.SIMD4_GPP, "simd4")):
        for bench in BENCH_SPARSITY:
            layers = bench_layers(bench)

            def app():
                # skip when EITHER sparse operand word is zero
                return cm.gpp_app_time([
                    cm.gpp_gemm_time(layer.m, layer.k, layer.n,
                                     sparsity=1 - (1 - act) * (1 - w),
                                     cfg=gpp)
                    for layer, act, w in layers], cfg=gpp)

            out, us = timed(app, dev)
            pscalar, psimd = paper_inference.get(bench, (None, None))
            ref = pscalar if label == "scalar" else psimd
            rows.append((f"fig14/{label}/{bench}", us,
                         f"app_reduction={out['app_reduction']:.3f};"
                         f"paper={ref};amenable={out['amenable_frac']:.2f}"))
    # training: BP benefits more (errors sparser than features)
    for phase, act_scale in (("fp", 1.0), ("bp_errors", 1.35)):
        times = [cm.gpp_gemm_time(layer.m, layer.k, layer.n,
                                  sparsity=min(0.9, a * act_scale),
                                  cfg=cm.SCALAR_GPP)
                 for layer, a, _ in bench_layers("cifar10")]
        out = cm.gpp_app_time(times, cfg=cm.SCALAR_GPP)
        rows.append((f"fig14/train/{phase}", 0.0,
                     f"app_reduction={out['app_reduction']:.3f};"
                     "paper_claim=BP>FP"))
    # tile-level app reduction at the planner's blocks
    for bench in ("alexnet", "deepcomp-alexnet"):
        base_s = sparce_s = 0.0
        for layer, act, w in bench_layers(bench):
            plan = bench_plan(layer, act, w)
            sv = cm.tpu_gemm_time(
                layer.m, layer.k, layer.n,
                tile_skip_frac=plan.expected_block_sparsity, dtype_bytes=4)
            base_s += sv.base_s
            sparce_s += sv.sparce_s
        rows.append((f"fig14/tpu_tile/{bench}", 0.0,
                     f"app_reduction={1 - sparce_s / base_s:.3f};"
                     "granularity=block"))
    return rows


# ----------------------------------------------------------------- fig 16
def fig16_row(layer, x: torch.Tensor, dev):
    """One conv layer of Fig. 16 over its features ``x``: (us, derived,
    instr_red, dcache_red). The GPP fields are modeled; the tile skip is
    measured on ``x``'s bitmap at the planner's blocks."""
    g = cm.gpp_gemm_time(layer.m, layer.k, layer.n,
                         sparsity=layer.act_sparsity, cfg=cm.SCALAR_GPP)
    instr_red = 1.0 - g["instr_frac_executed"]
    # the KER load is skipped, the INP load stays: half the data-side
    # accesses skip at rate p
    dcache_red = layer.act_sparsity * 0.5
    plan = sasa.plan_matmul(layer.m, layer.k, layer.n,
                            lhs_sparsity=layer.act_sparsity,
                            lhs_cluster=8 * 128)
    bmp, us = timed(lambda: sprf.compute_bitmap(
        x, (plan.block_m, plan.block_k)), dev)
    sv = cm.tpu_gemm_time(layer.m, layer.k, layer.n,
                          tile_skip_frac=float(bmp.sparsity()),
                          dtype_bytes=4)
    return us, (f"instr_red={instr_red:.3f};dcache_red={dcache_red:.3f};"
                f"tpu_flops_skipped={sv.flops_skipped_frac:.3f};"
                f"tpu_bytes_skipped={sv.bytes_skipped_frac:.3f}"), \
        instr_red, dcache_red


def fig16(dev, gen) -> List[Row]:
    """Paper Fig. 16: layer-wise benefit over AlexNet's conv layers."""
    rows, instr_reds, dcache_reds = [], [], []
    for layer in ALEXNET_GEMMS[:5]:
        x = sprf.random_sparse(gen, (layer.m, layer.k), layer.act_sparsity,
                               cluster=(8, 128))
        us, derived, instr_red, dcache_red = fig16_row(layer, x, dev)
        instr_reds.append(instr_red)
        dcache_reds.append(dcache_red)
        rows.append((f"fig16/{layer.name}", us, derived))
    rows.append(("fig16/avg_conv", 0.0,
                 f"instr_red={np.mean(instr_reds):.3f};paper=0.394;"
                 f"dcache_red={np.mean(dcache_reds):.3f};paper=0.351"))
    return rows


# ----------------------------------------------------------------- fig 17
def fig17_tpu_row(x: torch.Tensor, w: torch.Tensor, s: float, cluster,
                  dev) -> Tuple[float, str]:
    """The Fig. 17 matrix at word sparsity ``s``, run through
    ``ops.sparce_gemm`` under its plan (a gated lhs plan where the
    planner finds nothing to skip, as the reference runs it)."""
    m, k, n = FIG17_MKN
    plan = sasa.plan_matmul(m, k, n, lhs_sparsity=s,
                            lhs_cluster=_cluster_elems(cluster))
    bm, bk = plan.block_m, plan.block_k
    bmp = sprf.compute_bitmap(x, (bm, bk))
    tile_skip = float(bmp.sparsity())
    run_plan = plan if plan.gate != "none" else sasa.SkipPlan(
        gate="lhs", variant="gated", block_m=bm, block_k=bk,
        block_n=plan.block_n)
    _, us = timed_gemm(
        f"fig17 s={s} blocks {bm}x{bk}",
        lambda: kops.sparce_gemm(x, w, run_plan, lhs_bitmap=bmp), x, w, dev,
        block_m=bm, block_k=bk, block_n=plan.block_n, lhs=bmp.bits, iters=2)
    sv = cm.tpu_gemm_time(m, k, n, tile_skip_frac=tile_skip, dtype_bytes=4)
    return us, (f"word={s:.2f};tile_skip={tile_skip:.3f};"
                f"blocks={bm}x{bk};variant={plan.variant};"
                f"modeled_speedup={sv.speedup:.3f}")


def fig17(dev, gen) -> List[Row]:
    """Paper Fig. 17: scaling with sparsity on the 169x3456x384 matrix,
    the GPP model and the GEMM kernels under two zero geometries."""
    m, k, n = FIG17_MKN
    w = _normal(gen, (k, n))
    rows = []
    for s in (0.1, 0.3, 0.5, 0.7, 0.9):
        for gpp, label in ((cm.SCALAR_GPP, "scalar"),
                           (cm.SIMD4_GPP, "simd4")):
            g = cm.gpp_gemm_time(m, k, n, sparsity=s, cfg=gpp)
            rows.append((f"fig17/gpp_{label}/s{int(s*100)}", 0.0,
                         f"speedup={g['speedup']:.3f};"
                         f"instr_frac={g['instr_frac_executed']:.3f};"
                         f"ideal={1-s:.2f}"))
        for cluster, geo in (((8, 128), "clustered"), (None, "iid")):
            x = sprf.random_sparse(gen, (m, k), s, cluster=cluster)
            rows.append((f"fig17/tpu_{geo}/s{int(s*100)}",
                         *fig17_tpu_row(x, w, s, cluster, dev)))
    return rows


# ----------------------------------------------------------------- fig 18
def fig18_rows(feats: torch.Tensor, dense_w: torch.Tensor, dev
               ) -> List[Row]:
    """Paper Fig. 18: gate on the sparse features (lhs) or on the dense
    weights (rhs), and both operands sparse (the weights block-pruned to
    80%, the OR condition)."""
    m, k, n = FIG18_MKN
    bm, bk, bn = 8, 128, 128
    blocks = dict(block_m=bm, block_k=bk, block_n=bn)
    fb = sprf.compute_bitmap(feats, (bm, bk))
    _, us_a = timed_gemm(
        "fig18/features_gated",
        lambda: sg.sparce_gemm_gated(feats, dense_w, fb.bits, **blocks),
        feats, dense_w, dev, lhs=fb.bits, iters=2, **blocks)
    skip_a = float(fb.sparsity())
    sv_a = cm.tpu_gemm_time(m, k, n, tile_skip_frac=skip_a, dtype_bytes=4)
    wb = sprf.compute_bitmap(dense_w, (bk, bn))
    _, us_b = timed_gemm(
        "fig18/weights_gated",
        lambda: sg.sparce_gemm_gated(feats, dense_w, wb.bits, gate="rhs",
                                     **blocks),
        feats, dense_w, dev, rhs=wb.bits, iters=2, **blocks)
    skip_b = float(wb.sparsity())
    sv_b = cm.tpu_gemm_time(m, k, n, tile_skip_frac=skip_b, dtype_bytes=4)
    red_a = 1 - sv_a.sparce_s / sv_a.base_s
    red_b = 1 - sv_b.sparce_s / sv_b.base_s
    ratio = red_a / max(red_b, 1e-9)
    pruned = sprf.prune_weights(dense_w, 0.8, block=(bk, bn))
    pb = sprf.compute_bitmap(pruned, (bk, bn))
    _, us_both = timed_gemm(
        "fig18/both_sparse_or",
        lambda: sg.sparce_gemm_gated_both(feats, pruned, fb.bits, pb.bits,
                                          **blocks),
        feats, pruned, dev, lhs=fb.bits, rhs=pb.bits, iters=2, **blocks)
    or_skip = float(torch.maximum(fb.bits[:, :, None],
                                  pb.bits[None, :, :]).float().mean())
    return [
        ("fig18/features_gated", us_a,
         f"tile_skip={skip_a:.3f};time_red={red_a:.3f}"),
        ("fig18/weights_gated", us_b,
         f"tile_skip={skip_b:.3f};time_red={red_b:.3f}"),
        ("fig18/ordering_ratio", 0.0,
         f"ratio={min(ratio, 99):.2f};paper=1.86x_for_simd4"),
        ("fig18/both_sparse_or", us_both,
         f"or_tile_skip={or_skip:.3f};feat={float(fb.sparsity()):.2f};"
         f"weight={float(pb.sparsity()):.2f}"),
    ]


def fig18(dev, gen) -> List[Row]:
    m, k, n = FIG18_MKN
    feats = sprf.random_sparse(gen, (m, k), 0.62, cluster=(8, 128))
    return fig18_rows(feats, _normal(gen, (k, n)), dev)


# ------------------------------------------------------------ the examples
def demo_rows(x: torch.Tensor, w: torch.Tensor, dev,
              s: float = DEMO_SPARSITY) -> List[Row]:
    """``examples/sparse_gemm_demo.py``: the gated and the compacted
    kernel against the dense product, with the skip accounting the paper
    reports (instructions skipped -> tiles skipped; D-cache accesses ->
    weight-tile fetches)."""
    bm, bk, bn = DEMO_BLOCKS
    m, k, n = x.shape[0], x.shape[1], w.shape[1]
    bmp = sprf.compute_bitmap(x, (bm, bk))
    nm, nk = bmp.grid
    total, skipped = nm * nk, int(bmp.num_skipped())
    blocks = dict(block_m=bm, block_k=bk, block_n=bn)
    y_d, us_d = timed(lambda: x @ w, dev)
    y_g, us_g = timed_gemm(
        "demo/gated", lambda: sg.sparce_gemm_gated(x, w, bmp.bits, **blocks),
        x, w, dev, lhs=bmp.bits, **blocks)
    y_c, us_c = timed_gemm(
        "demo/compacted",
        lambda: sg.sparce_gemm_compacted(x, w, bmp.bits, **blocks), x, w,
        dev, lhs=bmp.bits, **blocks)
    frac = skipped / total
    sv = cm.tpu_gemm_time(m, k, n, tile_skip_frac=frac, dtype_bytes=4)
    err = lambda y: float((y - y_d).abs().max())  # noqa: E731
    return [
        ("demo/tiles", 0.0, f"word={s:.2f};skipped={skipped};"
         f"total={total};frac={frac:.3f}"),
        ("demo/dense", us_d, "x@w"),
        ("demo/gated", us_g, f"max_err_vs_dense={err(y_g):.2e}"),
        ("demo/compacted", us_c, f"max_err_vs_dense={err(y_c):.2e}"),
        ("demo/savings", 0.0, f"mxu_steps_skipped={frac:.3f};"
         f"hbm_fetch_skipped={sv.bytes_skipped_frac:.3f};"
         f"modeled_speedup={sv.speedup:.2f}"),
    ]


def quickstart_rows(x: torch.Tensor, w: torch.Tensor, dev) -> List[Row]:
    """Part 1 of ``examples/quickstart.py``: the planner's plan for
    ReLU-like features, their bitmap, and ``ops.sparce_gemm`` under the
    plan against the dense product."""
    m, k, n = x.shape[0], x.shape[1], w.shape[1]
    plan = sasa.plan_matmul(m, k, n, lhs_sparsity=0.6, lhs_cluster=8 * 128)
    bitmap = sprf.compute_bitmap(x, plan.block_lhs)
    y, us = timed_gemm(
        "quickstart/gemm",
        lambda: kops.sparce_gemm(x, w, plan, lhs_bitmap=bitmap), x, w, dev,
        block_m=plan.block_m, block_k=plan.block_k, block_n=plan.block_n,
        lhs=bitmap.bits if plan.gate == "lhs" else None)
    err = float((y - x @ w).abs().max())
    tile = float(bitmap.sparsity())
    sv = cm.tpu_gemm_time(m, k, n, tile_skip_frac=tile, dtype_bytes=4)
    return [
        ("quickstart/plan", 0.0, f"gate={plan.gate};variant={plan.variant};"
         f"blocks={plan.block_m}x{plan.block_k}x{plan.block_n}"),
        ("quickstart/gemm", us, f"tile_sparsity={tile:.3f};"
         f"max_err_vs_dense={err:.2e};modeled_speedup={sv.speedup:.2f}"),
    ]


def demo(dev, gen) -> List[Row]:
    m, k, n = DEMO_MKN
    bm, bk, _ = DEMO_BLOCKS
    x = sprf.random_sparse(gen, (m, k), DEMO_SPARSITY, cluster=(bm, bk))
    rows = demo_rows(x, _normal(gen, (k, n)), dev)
    m, k, n = QUICKSTART_MKN
    # features out of a ReLU layer: ~60% zeros, clustered in rows
    x = sprf.random_sparse(gen, (m, k), 0.6, cluster=(8, 128))
    return rows + quickstart_rows(x, _normal(gen, (k, n)) * 0.02, dev)


RUNNERS = {"4": fig4, "14": fig14, "16": fig16, "17": fig17, "18": fig18,
           "demo": demo}
FIGS = tuple(RUNNERS)


def run(figs, device="cuda", seed: int = 0) -> List[Row]:
    """Every row of ``figs`` (names from :data:`FIGS`), printed as it is
    made; returns them."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: List[Row] = []
    for fig in figs:
        if fig not in RUNNERS:
            raise ValueError(f"unknown figure {fig!r}; known: {FIGS}")
        for row in RUNNERS[fig](dev, gen):
            print(format_row(*row), flush=True)
            rows.append(row)
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--figs", default=",".join(FIGS),
                    help=f"comma-separated subset of {','.join(FIGS)}")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain kernel versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.figs.split(","), device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
