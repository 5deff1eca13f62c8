"""The paper's evaluation path on the port, against the reference: the
GEMM planner (``plan_matmul``, its cache, ``analyze_network``), the GPP
and GEMM-saving cost models, the evaluation's operands (pruned weights,
random sparse matrices, bitmaps), the ``paper-alexnet`` config, and the
rows of ``repro_torch.launch.figures`` against the reference's figure
scripts.

Deterministic rows must equal the reference's text (the ``us`` column
aside). Rows with random operands are computed by helpers that take
their operands, so both packages get the same numpy arrays here.
Plans, cost-model dicts and analysis summaries are plain Python floats
and must be exactly equal.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import paper_alexnet as ref_alexnet
from repro.core import cost_model as ref_cm
from repro.core import sasa as ref_sasa
from repro.core import sprf as ref_sprf
from repro_torch import bridge
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs import paper_alexnet
from repro_torch.core import cost_model as cm
from repro_torch.core import sasa, sprf
from repro_torch.launch import figures

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:  # the reference's figure scripts live there
    sys.path.insert(0, ROOT)

FIG14_CLUSTERS = dict(lhs_cluster=8 * 128, rhs_cluster=64 * 128)


def _fields(obj):
    return dataclasses.asdict(obj)


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize("bench", list(ref_alexnet.BENCH_SPARSITY))
@pytest.mark.parametrize("deepcomp", [False, True])
def test_plan_matmul_equals_reference_over_alexnet_table(bench, deepcomp):
    """Every AlexNet layer at the benchmark's scaled feature sparsity,
    with and without the deep-compression weight sparsity, at fig14's
    clusters."""
    scale = ref_alexnet.BENCH_SPARSITY[bench] / 0.36
    for layer in ref_alexnet.ALEXNET_GEMMS:
        act = min(0.9, layer.act_sparsity * scale)
        w = ref_alexnet.DEEPCOMP_WEIGHT_SPARSITY[layer.name] if deepcomp \
            else 0.0
        kw = dict(lhs_sparsity=act, rhs_sparsity=w, **FIG14_CLUSTERS)
        got = sasa.plan_matmul(layer.m, layer.k, layer.n, **kw)
        want = ref_sasa.plan_matmul(layer.m, layer.k, layer.n, **kw)
        assert _fields(got) == _fields(want), layer.name


@pytest.mark.parametrize("s", [0.1, 0.3, 0.5, 0.7, 0.9])
def test_plan_matmul_equals_reference_on_fig17(s):
    for cluster in (8 * 128, 1):  # clustered and iid geometries
        got = sasa.plan_matmul(169, 3456, 384, lhs_sparsity=s,
                               lhs_cluster=cluster)
        want = ref_sasa.plan_matmul(169, 3456, 384, lhs_sparsity=s,
                                    lhs_cluster=cluster)
        assert _fields(got) == _fields(want)


@pytest.mark.parametrize("mkn,kw", [
    ((512, 2048, 512), dict(lhs_sparsity=0.6, lhs_cluster=8 * 128)),
    ((512, 2048, 512), dict(lhs_sparsity=0.6, lhs_cluster=8 * 128,
                            dtype="bfloat16")),
    ((100, 300, 200), dict(lhs_sparsity=0.7, rhs_sparsity=0.2,
                           block_m=64, block_k=128, block_n=128)),
    ((4096, 4096, 4096), dict(rhs_sparsity=0.5, rhs_cluster=4096,
                              block_m=2048, block_k=2048, block_n=2048)),
    ((169, 3456, 384), dict(lhs_sparsity=0.6, block_k=256)),
    ((3025, 363, 96), dict(lhs_sparsity=0.3, rhs_sparsity=0.8,
                           rhs_cluster=64, dtype="bfloat16")),
    ((1, 9216, 4096), dict(lhs_sparsity=0.9, rhs_sparsity=0.9,
                           min_expected_block_sparsity=0.5)),
])
def test_plan_matmul_equals_reference_on_overrides_and_dtypes(mkn, kw):
    """The quickstart shape, bf16, explicit (and oversized, so the
    working-set loop halves them) block overrides, a partial override."""
    got = sasa.plan_matmul(*mkn, **kw)
    want = ref_sasa.plan_matmul(*mkn, **kw)
    assert _fields(got) == _fields(want)
    assert sasa.expected_block_sparsity(0.6, 1024, 8) == \
        ref_sasa.expected_block_sparsity(0.6, 1024, 8)


def test_plan_matmul_cached_counts_like_reference():
    """Bucketed sparsities give plan_matmul's plan for the bucketed
    values; hits and misses count as the reference's."""
    calls = [
        ((169, 3456, 384), dict(lhs_sparsity=0.62, lhs_cluster=1024)),
        ((169, 3456, 384), dict(lhs_sparsity=0.621, lhs_cluster=1024)),
        ((169, 3456, 384), dict(lhs_sparsity=0.7, lhs_cluster=1024)),
        ((1, 9216, 4096), dict(lhs_sparsity=0.65, rhs_sparsity=0.85,
                               **FIG14_CLUSTERS)),
        ((169, 3456, 384), dict(lhs_sparsity=0.62, lhs_cluster=1024)),
        ((1, 9216, 4096), dict(lhs_sparsity=0.65, rhs_sparsity=0.85,
                               **FIG14_CLUSTERS)),
    ]
    sasa.plan_cache_clear()
    ref_sasa.plan_cache_clear()
    for mkn, kw in calls:
        got = sasa.plan_matmul_cached(*mkn, **kw)
        want = ref_sasa.plan_matmul_cached(*mkn, **kw)
        assert _fields(got) == _fields(want)
        bucketed = dict(kw, **{key: sasa._bucket_sparsity(kw[key])
                               for key in ("lhs_sparsity", "rhs_sparsity")
                               if key in kw})
        assert got == sasa.plan_matmul(*mkn, **bucketed)
        assert sasa.plan_cache_stats() == ref_sasa.plan_cache_stats()
    assert sasa.plan_cache_stats()["hits"] == 3


@pytest.mark.parametrize("deepcomp,kw", [
    (False, dict()),
    (False, dict(act_cluster=8 * 128, weight_cluster=64 * 128)),
    (True, dict(act_cluster=8 * 128, weight_cluster=64 * 128)),
    (True, dict(dtype="bfloat16")),
])
def test_analyze_network_equals_reference(deepcomp, kw):
    layers, ref_layers = [], []
    for layer in ref_alexnet.ALEXNET_GEMMS:
        w = ref_alexnet.DEEPCOMP_WEIGHT_SPARSITY[layer.name] if deepcomp \
            else 0.0
        ref_layers.append(dataclasses.replace(layer, weight_sparsity=w))
        layers.append(sasa.LayerSpec(**_fields(ref_layers[-1])))
    got = sasa.analyze_network(layers, **kw)
    want = ref_sasa.analyze_network(ref_layers, **kw)
    assert set(got) == set(want)
    assert {k: _fields(p) for k, p in got["plans"].items()} == \
        {k: _fields(p) for k, p in want["plans"].items()}
    for key in ("distinct_plans", "total_flops", "word_redundant_frac",
                "tile_redundant_frac"):
        assert got[key] == want[key], key


def test_paper_alexnet_config_equals_reference():
    ref = ref_get_config("paper-alexnet")
    got = get_config("paper-alexnet")
    assert _fields(got) == _fields(ref)
    assert [_fields(layer) for layer in paper_alexnet.ALEXNET_GEMMS] == \
        [_fields(layer) for layer in ref_alexnet.ALEXNET_GEMMS]
    assert paper_alexnet.BENCH_SPARSITY == ref_alexnet.BENCH_SPARSITY
    assert paper_alexnet.DEEPCOMP_WEIGHT_SPARSITY == \
        ref_alexnet.DEEPCOMP_WEIGHT_SPARSITY
    assert "paper-alexnet" not in ARCH_NAMES


# --------------------------------------------------------------- cost model
@pytest.mark.parametrize("cfg_name", ["SCALAR_GPP", "SIMD4_GPP"])
def test_gpp_models_equal_reference(cfg_name):
    cfg, ref_cfg = getattr(cm, cfg_name), getattr(ref_cm, cfg_name)
    assert _fields(cfg) == _fields(ref_cfg)
    assert cm.gpp_mac_cycles(cfg) == ref_cm.gpp_mac_cycles(ref_cfg)
    times, ref_times = [], []
    for (m, k, n) in ((3025, 363, 96), (169, 3456, 384), (1, 9216, 4096)):
        for s in (0.0, 0.1, 0.36, 0.62, 0.9, 1.0):
            for bs in (None, 0.0, 0.3):
                if s == 1.0 and bs is None:
                    continue  # the model divides by the executed share
                got = cm.gpp_gemm_time(m, k, n, sparsity=s, cfg=cfg,
                                       block_sparsity=bs)
                want = ref_cm.gpp_gemm_time(m, k, n, sparsity=s,
                                            cfg=ref_cfg, block_sparsity=bs)
                assert got == want
                times.append(got)
                ref_times.append(want)
    assert cm.gpp_app_time(times, cfg=cfg) == \
        ref_cm.gpp_app_time(ref_times, cfg=ref_cfg)


def test_gemm_savings_model_equals_reference():
    for (m, k, n) in ((169, 3456, 384), (1, 9216, 4096), (256, 3456, 384)):
        for f in (0.0, 0.39, 0.62, 0.903, 1.0):
            for kw in (dict(dtype_bytes=4), dict(), dict(fetch_skip=False),
                       dict(chips=4, dtype_bytes=4)):
                got = cm.tpu_gemm_time(m, k, n, tile_skip_frac=f, **kw)
                want = ref_cm.tpu_gemm_time(m, k, n, tile_skip_frac=f, **kw)
                assert _fields(got) == _fields(want)
                assert got.speedup == want.speedup


# ----------------------------------------------------------------- operands
@pytest.mark.parametrize("block", [None, (128, 128), (64, 100)])
@pytest.mark.parametrize("sparsity", [0.0, 0.37, 0.8])
def test_prune_weights_equals_reference(block, sparsity):
    w = np.random.default_rng(60).standard_normal((300, 256)).astype(
        np.float32)
    got = sprf.prune_weights(torch.from_numpy(w), sparsity, block=block)
    want = ref_sprf.prune_weights(jnp.asarray(w), sparsity, block=block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prune_weights_returns_a_dense_tensor_at_ragged_shapes():
    """Block pruning pads to whole blocks and slices back; like the
    reference's array, the result is dense (the GEMM wrappers would copy
    a strided view on every call)."""
    w = np.random.default_rng(61).standard_normal((300, 250)).astype(
        np.float32)
    got = sprf.prune_weights(torch.from_numpy(w), 0.5, block=(128, 128))
    assert got.is_contiguous() and tuple(got.shape) == (300, 250)
    want = ref_sprf.prune_weights(jnp.asarray(w), 0.5, block=(128, 128))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block", [None, (2, 2)])
def test_prune_weights_ties_at_the_threshold(block):
    """Equal magnitudes at the k-th smallest: the reference prunes every
    word with |w| <= the threshold, and keeps only blocks strictly above
    the k-th smallest norm, so ties are pruned in both modes."""
    w = np.ones((4, 4), np.float32)
    w[0, 0], w[0, 1] = 5.0, -5.0  # the other three 2x2 blocks tie
    got = sprf.prune_weights(torch.from_numpy(w), 0.5, block=block)
    want = np.asarray(ref_sprf.prune_weights(jnp.asarray(w), 0.5,
                                             block=block))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).sum() > 8  # more than half: the ties went too
    with pytest.raises(ValueError, match="sparsity"):
        sprf.prune_weights(torch.from_numpy(w), 1.0)


@pytest.mark.parametrize("shape,cluster", [
    ((169, 3456), None), ((169, 3456), (8, 128)), ((20, 300), (8, 128)),
    ((1, 9216), (8, 128)),
])
@pytest.mark.parametrize("sparsity", [0.0, 0.52, 0.9])
def test_random_sparse_exact_counts_and_geometry(shape, cluster, sparsity):
    gen = torch.Generator().manual_seed(3)
    x = sprf.random_sparse(gen, shape, sparsity, cluster=cluster)
    assert tuple(x.shape) == shape and x.dtype == torch.float32
    ref = np.array(ref_sprf.random_sparse(
        jax.random.PRNGKey(3), shape, sparsity, cluster=cluster))
    if cluster is None:
        n = shape[0] * shape[1]
        assert int((x == 0).sum()) == round(sparsity * n) == \
            int((ref == 0).sum())
    else:
        cr, cc = cluster
        gr, gc = -(-shape[0] // cr), -(-shape[1] // cc)
        pad = torch.nn.functional.pad(
            x, (0, gc * cc - shape[1], 0, gr * cr - shape[0]),
            value=float("nan"))
        tiles = pad.reshape(gr, cr, gc, cc)
        zero = ((tiles == 0) | tiles.isnan()).all(3).all(1)
        some = (tiles == 0).any(3).any(1)
        assert torch.equal(zero, some)  # whole clusters, cut at the edge
        assert int(zero.sum()) == round(sparsity * gr * gc)
        ref_zero = sprf.compute_bitmap(torch.from_numpy(ref), cluster).bits
        assert int(ref_zero.sum()) == int(zero.sum())
    again = sprf.random_sparse(torch.Generator().manual_seed(3), shape,
                               sparsity, cluster=cluster)
    assert torch.equal(again, x)
    other = sprf.random_sparse(torch.Generator().manual_seed(4), shape,
                               sparsity, cluster=cluster)
    assert not torch.equal(other, x)
    b16 = sprf.random_sparse(torch.Generator().manual_seed(3), shape,
                             sparsity, dtype=torch.bfloat16, cluster=cluster)
    assert b16.dtype == torch.bfloat16 and torch.equal(b16 == 0, x == 0)


def test_tile_bitmap_methods_equal_reference():
    rng = np.random.default_rng(61)
    x = rng.standard_normal((40, 300)).astype(np.float32)
    x[:8, :128] = 0.0
    x[16:24] = 0.0
    y = rng.standard_normal((40, 300)).astype(np.float32)
    y[:, 128:256] = 0.0
    bx = sprf.weight_bitmap(torch.from_numpy(x), (8, 128))
    by = sprf.compute_bitmap(torch.from_numpy(y), (8, 128))
    rx = ref_sprf.weight_bitmap(jnp.asarray(x), (8, 128))
    ry = ref_sprf.compute_bitmap(jnp.asarray(y), (8, 128))
    assert bx.grid == tuple(rx.grid) == (5, 3)
    assert float(bx.sparsity()) == float(rx.sparsity())
    assert int(bx.num_skipped()) == int(rx.num_skipped())
    t, rt = bx.transpose(), rx.transpose()
    assert (t.block, t.shape) == (rt.block, rt.shape)
    np.testing.assert_array_equal(t.bits.numpy(), np.asarray(rt.bits))
    o, ro = bx.logical_or(by), rx.logical_or(ry)
    np.testing.assert_array_equal(o.bits.numpy(), np.asarray(ro.bits))
    assert bridge.bitmap_from_reference(ro).bits.dtype == torch.int32
    with pytest.raises(ValueError, match="bitmaps differ"):
        bx.logical_or(t)


# ------------------------------------------------------------ figure rows
def _rows(text):
    """{name: derived} of CSV rows ``name,us,derived``."""
    out = {}
    for line in text.splitlines():
        name, _us, derived = line.split(",", 2)
        out[name] = derived
    return out


def _port_rows(fig):
    return {name: derived
            for name, _, derived in figures.RUNNERS[fig](
                torch.device("cpu"), torch.Generator().manual_seed(0))}


def test_fig14_rows_equal_reference_script(capsys):
    from benchmarks import fig14_app_time
    fig14_app_time.run()
    want = _rows(capsys.readouterr().out)
    assert _port_rows("14") == want
    assert len(want) == 16


def test_fig4_deterministic_rows_equal_reference_script(capsys):
    from benchmarks import fig4_redundant_ops
    fig4_redundant_ops.run()
    want = _rows(capsys.readouterr().out)
    got = _port_rows("4")
    assert set(got) == set(want)
    fixed = [n for n in want if not n.startswith("fig4/tile_harvest")]
    assert len(fixed) == 8
    assert {n: got[n] for n in fixed} == {n: want[n] for n in fixed}


def _clustered(rng, shape, sparsity, cluster):
    """numpy features with exactly round(sparsity * clusters) zeroed
    clusters (cut at the ragged edge)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if cluster is None:
        flat = x.reshape(-1)
        flat[rng.permutation(flat.size)[:round(sparsity * flat.size)]] = 0.0
        return x
    cr, cc = cluster
    gr, gc = -(-shape[0] // cr), -(-shape[1] // cc)
    for c in rng.permutation(gr * gc)[:round(sparsity * gr * gc)]:
        i, j = divmod(int(c), gc)
        x[i * cr:(i + 1) * cr, j * cc:(j + 1) * cc] = 0.0
    return x


@pytest.mark.parametrize("cluster", [None, (8, 128)])
def test_fig4_tile_harvest_row_equals_reference_on_same_operands(cluster):
    layer = ref_alexnet.ALEXNET_GEMMS[3]
    x = _clustered(np.random.default_rng(62), (layer.m, layer.k),
                   layer.act_sparsity, cluster)
    _, derived = figures.fig4_tile_harvest(torch.from_numpy(x), cluster,
                                           torch.device("cpu"))
    plan = ref_sasa.plan_matmul(
        layer.m, layer.k, layer.n, lhs_sparsity=layer.act_sparsity,
        lhs_cluster=1 if cluster is None else cluster[0] * cluster[1])
    bmp = ref_sprf.compute_bitmap(jnp.asarray(x), (plan.block_m,
                                                   plan.block_k))
    assert derived == (f"word={layer.act_sparsity:.2f};"
                       f"tile={float(bmp.sparsity()):.3f};"
                       f"block={plan.block_m}x{plan.block_k}")


def test_fig16_rows_equal_reference_on_same_operands():
    rng = np.random.default_rng(63)
    for layer in ref_alexnet.ALEXNET_GEMMS[:5]:
        x = _clustered(rng, (layer.m, layer.k), layer.act_sparsity, (8, 128))
        _, derived, _, _ = figures.fig16_row(
            layer, torch.from_numpy(x), torch.device("cpu"))
        # the reference script's arithmetic on the same operand
        g = ref_cm.gpp_gemm_time(layer.m, layer.k, layer.n,
                                 sparsity=layer.act_sparsity,
                                 cfg=ref_cm.SCALAR_GPP)
        plan = ref_sasa.plan_matmul(layer.m, layer.k, layer.n,
                                    lhs_sparsity=layer.act_sparsity,
                                    lhs_cluster=8 * 128)
        bmp = ref_sprf.compute_bitmap(jnp.asarray(x),
                                      (plan.block_m, plan.block_k))
        sv = ref_cm.tpu_gemm_time(layer.m, layer.k, layer.n,
                                  tile_skip_frac=float(bmp.sparsity()),
                                  dtype_bytes=4)
        assert derived == (
            f"instr_red={1.0 - g['instr_frac_executed']:.3f};"
            f"dcache_red={layer.act_sparsity * 0.5:.3f};"
            f"tpu_flops_skipped={sv.flops_skipped_frac:.3f};"
            f"tpu_bytes_skipped={sv.bytes_skipped_frac:.3f}"), layer.name


@pytest.mark.parametrize("s", [0.3, 0.7])
@pytest.mark.parametrize("cluster", [(8, 128), None])
def test_fig17_rows_equal_reference_on_same_operands(s, cluster):
    m, k, n = figures.FIG17_MKN
    rng = np.random.default_rng(64)
    x = _clustered(rng, (m, k), s, cluster)
    w = rng.standard_normal((k, n)).astype(np.float32)
    _, derived = figures.fig17_tpu_row(*map(torch.from_numpy, (x, w)), s,
                                       cluster, torch.device("cpu"))
    plan = ref_sasa.plan_matmul(
        m, k, n, lhs_sparsity=s,
        lhs_cluster=1 if cluster is None else cluster[0] * cluster[1])
    bmp = ref_sprf.compute_bitmap(jnp.asarray(x), (plan.block_m,
                                                   plan.block_k))
    tile_skip = float(bmp.sparsity())
    sv = ref_cm.tpu_gemm_time(m, k, n, tile_skip_frac=tile_skip,
                              dtype_bytes=4)
    assert derived == (f"word={s:.2f};tile_skip={tile_skip:.3f};"
                       f"blocks={plan.block_m}x{plan.block_k};"
                       f"variant={plan.variant};"
                       f"modeled_speedup={sv.speedup:.3f}")


def test_fig18_rows_equal_reference_on_same_operands():
    m, k, n = figures.FIG18_MKN
    rng = np.random.default_rng(65)
    feats = _clustered(rng, (m, k), 0.62, (8, 128))
    w = rng.standard_normal((k, n)).astype(np.float32)
    got = {name: d for name, _, d in figures.fig18_rows(
        torch.from_numpy(feats), torch.from_numpy(w), torch.device("cpu"))}
    fb = ref_sprf.compute_bitmap(jnp.asarray(feats), (8, 128))
    wb = ref_sprf.compute_bitmap(jnp.asarray(w), (128, 128))
    pb = ref_sprf.compute_bitmap(ref_sprf.prune_weights(
        jnp.asarray(w), 0.8, block=(128, 128)), (128, 128))
    sv_a = ref_cm.tpu_gemm_time(m, k, n, tile_skip_frac=float(
        fb.sparsity()), dtype_bytes=4)
    sv_b = ref_cm.tpu_gemm_time(m, k, n, tile_skip_frac=float(
        wb.sparsity()), dtype_bytes=4)
    red_a = 1 - sv_a.sparce_s / sv_a.base_s
    red_b = 1 - sv_b.sparce_s / sv_b.base_s
    or_skip = float(jnp.mean(jnp.maximum(
        fb.bits[:, :, None], pb.bits[None, :, :]).astype(jnp.float32)))
    assert got == {
        "fig18/features_gated":
            f"tile_skip={float(fb.sparsity()):.3f};time_red={red_a:.3f}",
        "fig18/weights_gated":
            f"tile_skip={float(wb.sparsity()):.3f};time_red={red_b:.3f}",
        "fig18/ordering_ratio":
            f"ratio={min(red_a / max(red_b, 1e-9), 99):.2f};"
            "paper=1.86x_for_simd4",
        "fig18/both_sparse_or":
            f"or_tile_skip={or_skip:.3f};feat={float(fb.sparsity()):.2f};"
            f"weight={float(pb.sparsity()):.2f}",
    }


def test_demo_and_quickstart_rows_equal_reference_on_same_operands():
    rng = np.random.default_rng(66)
    m, k, n = figures.DEMO_MKN
    x = _clustered(rng, (m, k), figures.DEMO_SPARSITY, (8, 128))
    w = rng.standard_normal((k, n)).astype(np.float32)
    got = {name: d for name, _, d in figures.demo_rows(
        torch.from_numpy(x), torch.from_numpy(w), torch.device("cpu"))}
    bmp = ref_sprf.compute_bitmap(jnp.asarray(x), (8, 128))
    skipped, total = int(bmp.num_skipped()), bmp.bits.size
    sv = ref_cm.tpu_gemm_time(m, k, n, tile_skip_frac=skipped / total,
                              dtype_bytes=4)
    assert got["demo/tiles"] == (f"word=0.70;skipped={skipped};"
                                 f"total={total};frac={skipped/total:.3f}")
    assert got["demo/savings"] == (
        f"mxu_steps_skipped={skipped/total:.3f};"
        f"hbm_fetch_skipped={sv.bytes_skipped_frac:.3f};"
        f"modeled_speedup={sv.speedup:.2f}")
    for name in ("demo/gated", "demo/compacted"):  # honest bits: exact
        assert float(got[name].split("=")[1]) < 1e-3, got[name]
    m, k, n = figures.QUICKSTART_MKN
    x = _clustered(rng, (m, k), 0.6, (8, 128))
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    got = {name: d for name, _, d in figures.quickstart_rows(
        torch.from_numpy(x), torch.from_numpy(w), torch.device("cpu"))}
    plan = ref_sasa.plan_matmul(m, k, n, lhs_sparsity=0.6,
                                lhs_cluster=8 * 128)
    tile = float(ref_sprf.compute_bitmap(jnp.asarray(x),
                                         plan.block_lhs).sparsity())
    sv = ref_cm.tpu_gemm_time(m, k, n, tile_skip_frac=tile, dtype_bytes=4)
    assert got["quickstart/plan"] == "gate=lhs;variant=compacted;" \
        "blocks=8x128x256"
    tile_s, err_s, speed_s = got["quickstart/gemm"].split(";")
    assert tile_s == f"tile_sparsity={tile:.3f}"
    assert speed_s == f"modeled_speedup={sv.speedup:.2f}"
    assert float(err_s.split("=")[1]) < 1e-4


def test_figures_cli_on_cpu_and_its_device_default(capsys):
    assert figures.main(["--figs", "14,18", "--device", "cpu",
                         "--seed", "1"]) == 0
    rows = _rows(capsys.readouterr().out)
    assert len(rows) == 20 and "fig18/both_sparse_or" in rows
    with pytest.raises(ValueError, match="unknown figure"):
        figures.run(["19"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            figures.main(["--figs", "14"])


def test_new_modules_import_no_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch.launch.figures, repro_torch.configs\n"
        "import repro_torch.configs.paper_alexnet, repro_torch.bridge\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
