"""The compacted-grid and two-sided-gate GEMMs and the relu backward of the
port, against the reference's Pallas kernels (interpret mode, as the
reference's own kernel tests run them), their skip contracts (NaN
poison), the routing of ``ops.sparce_gemm``, and the paper's evaluation
path as a whole: every plan ``plan_matmul`` makes for a reduced AlexNet
layer table, run through ``ops.sparce_gemm`` in both packages.

On the CPU each wrapper runs its kernel's plain version. Inputs come
from numpy seeds and go to both packages. Weights are init-scale
(1/sqrt(K)), so outputs are O(1) and f32 sums in another order stay
well inside the stated 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_alexnet import (
    ALEXNET_GEMMS as REF_GEMMS, BENCH_SPARSITY, DEEPCOMP_WEIGHT_SPARSITY,
)
from repro.core import sasa as ref_sasa
from repro.core import sparse_ops as ref_sparse_ops
from repro.core import sprf as ref_sprf
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro.kernels import relu_bitmap as ref_rb
from repro.kernels import sparce_gemm as ref_sg
from repro_torch import bridge
from repro_torch.core import sasa, sparse_ops, sprf
from repro_torch.core.sasa import SkipPlan
from repro_torch.core.sprf import TileBitmap
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import relu_bitmap as rb
from repro_torch.kernels import sparce_gemm as sg

# f32: the plain versions sum each live tile stripe in one matmul, the
# Pallas kernels tile by tile; outputs are O(1).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 outputs: one bf16 ulp of values ~1-4 after f32 sums in another
# order.
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return rng, x, w


# ---------------------------------------------------------------- compacted
@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (32, 512, 256, 8, 128, 256),   # the AlexNet plans' blocks
    (24, 384, 256, 8, 128, 128),
    (168, 256, 128, 168, 128, 128),  # one 168-row tile
    (16, 256, 256, 1, 128, 128),
])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95])
def test_compacted_plain_matches_reference_kernel(M, K, N, bm, bk, bn,
                                                  sparsity):
    """Random (dishonest) bits: the product follows the bits."""
    rng, x, w = _operands(40, M, K, N)
    bits = (rng.random((M // bm, K // bk)) < sparsity).astype(np.int32)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    want = ref_sg.sparce_gemm_compacted(*_j(x, w, bits), interpret=True,
                                        **kw)
    got = sg.sparce_gemm_compacted(*_t(x, w, bits), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    oracle = kref.sparce_gemm_ref(*_t(x, w), bits_lhs=torch.from_numpy(bits),
                                  **kw)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **F32_TOL)


def test_compacted_all_skip_bits_yield_exact_zero():
    """nnz == 0 in every row tile over a fully nonzero x: exact zeros."""
    M, K, N, bm, bk, bn = 128, 256, 128, 64, 128, 128
    _, x, w = _operands(41, M, K, N)
    bits = np.ones((M // bm, K // bk), np.int32)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    want = ref_sg.sparce_gemm_compacted(*_j(x, w, bits), interpret=True,
                                        **kw)
    got = sg.sparce_gemm_compacted(*_t(x, w, bits), **kw)
    assert float(jnp.abs(want).max()) == 0.0
    assert float(got.abs().max()) == 0.0


def test_compacted_mixed_nnz_zero_rows():
    """Row tiles alternate nnz == 0 / dense; NaN where the bits skip, so
    a row tile with an empty list must not touch its first tile."""
    M, K, N, bm, bk, bn = 192, 256, 128, 64, 128, 128
    rng, x, w = _operands(42, M, K, N)
    x = np.abs(x) + 0.1
    bits = np.zeros((M // bm, K // bk), np.int32)
    bits[1, :] = 1  # middle row tile: nnz == 0
    x[64:128, :] = np.nan
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    want = np.asarray(ref_sg.sparce_gemm_compacted(*_j(x, w, bits),
                                                   interpret=True, **kw))
    got = sg.sparce_gemm_compacted(*_t(x, w, bits), **kw).numpy()
    assert np.abs(got[64:128]).max() == 0.0
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_compacted_nan_poisoned_dead_tiles_and_stripes_never_read():
    """NaN in every gated x tile and in every w k-stripe that no live row
    tile lists: y is bit-identical. Poisoning a live tile does reach y."""
    M, K, N, bm, bk, bn = 24, 512, 256, 8, 128, 256
    rng, x, w = _operands(43, M, K, N)
    bits = (rng.random((M // bm, K // bk)) < 0.4).astype(np.int32)
    bits[:, 2] = 1  # k-stripe 2 listed by no row tile
    bits[0] = 1  # row tile 0: nnz == 0
    bits[1, 0] = 0
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    y = sg.sparce_gemm_compacted(*_t(x, w, bits), **kw)
    x2, w2 = x.copy(), w.copy()
    for i, j in zip(*np.nonzero(bits)):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = np.nan
    w2[2 * bk:3 * bk] = np.nan
    y2 = sg.sparce_gemm_compacted(*_t(x2, w2, bits), **kw)
    assert torch.isfinite(y2).all() and torch.equal(y2, y)
    assert (y[:bm] == 0).all()
    x3 = x.copy()
    x3[bm, 0] = np.nan  # tile (1, 0) is live
    y3 = sg.sparce_gemm_compacted(*_t(x3, w, bits), **kw)
    assert torch.isnan(y3[bm]).all() and torch.isfinite(y3[2 * bm:]).all()


@pytest.mark.parametrize("M,K,N", [(32, 512, 256), (20, 300, 200)])
def test_rhs_compacted_through_ops_transpose_matches_reference(M, K, N):
    """An rhs-compacted plan runs the compacted kernel on (w.T, x.T,
    bits.T) with blocks (bn, bk, bm), transposed back; ragged dims."""
    bm, bk, bn = 8, 128, 128
    rng, x, w = _operands(44, M, K, N)
    grid = (-(-K // bk), -(-N // bn))
    bits = (rng.random(grid) < 0.5).astype(np.int32)
    plan = SkipPlan(gate="rhs", variant="compacted", block_m=bm, block_k=bk,
                    block_n=bn)
    got = kops.sparce_gemm(*_t(x, w), plan, rhs_bitmap=TileBitmap(
        torch.from_numpy(bits), (bk, bn), (K, N)))
    want = ref_ops.sparce_gemm(
        *_j(x, w), ref_sasa.SkipPlan(gate="rhs", variant="compacted",
                                     block_m=bm, block_k=bk, block_n=bn),
        rhs_bitmap=ref_sprf.TileBitmap(jnp.asarray(bits), (bk, bn), (K, N)))
    assert tuple(got.shape) == (M, N) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_compacted_bf16_matches_reference_kernel():
    M, K, N, bm, bk, bn = 16, 256, 256, 8, 128, 256
    rng, x, w = _operands(45, M, K, N)
    bits = (rng.random((M // bm, K // bk)) < 0.5).astype(np.int32)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    want = ref_sg.sparce_gemm_compacted(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(bits), interpret=True, **kw)
    got = sg.sparce_gemm_compacted(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(bits), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


# ----------------------------------------------------------- two-sided gate
@pytest.mark.parametrize("M,K,N,bn", [
    (32, 512, 256, 256),  # deepcomp conv5's blocks (8, 128, 256)
    (8, 512, 384, 128),   # deepcomp fc6-fc8's (8, 128, 128)
])
@pytest.mark.parametrize("sparsity", [0.3, 0.7])
def test_both_plain_matches_reference_kernel(M, K, N, bn, sparsity):
    bm, bk = 8, 128
    rng, x, w = _operands(46, M, K, N)
    lbits = (rng.random((M // bm, K // bk)) < sparsity).astype(np.int32)
    rbits = (rng.random((K // bk, N // bn)) < sparsity).astype(np.int32)
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    want = ref_sg.sparce_gemm_gated_both(*_j(x, w, lbits, rbits),
                                         interpret=True, **kw)
    got = sg.sparce_gemm_gated_both(*_t(x, w, lbits, rbits), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    oracle = ref_kref.sparce_gemm_ref(*_j(x, w), bits_lhs=jnp.asarray(lbits),
                                      bits_rhs=jnp.asarray(rbits), **kw)
    port_oracle = kref.sparce_gemm_ref(
        *_t(x, w), bits_lhs=torch.from_numpy(lbits),
        bits_rhs=torch.from_numpy(rbits), **kw)
    np.testing.assert_allclose(port_oracle.numpy(), np.asarray(oracle),
                               **F32_TOL)
    np.testing.assert_allclose(got.numpy(), port_oracle.numpy(), **F32_TOL)


def test_both_nan_poisoned_gated_tiles_never_read():
    """NaN in every x tile whose lhs bit is 1, and in every w tile whose
    product is dropped for every row tile (its rhs bit is 1, or every
    row tile's lhs bit at that k is 1): y is bit-identical."""
    M, K, N, bm, bk, bn = 24, 512, 256, 8, 128, 128
    rng, x, w = _operands(47, M, K, N)
    lbits = (rng.random((M // bm, K // bk)) < 0.4).astype(np.int32)
    lbits[:, 3] = 1  # k tile 3 dropped for every row tile
    rbits = (rng.random((K // bk, N // bn)) < 0.4).astype(np.int32)
    rbits[0, 0] = 0
    lbits[0, 0] = 0
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    y = sg.sparce_gemm_gated_both(*_t(x, w, lbits, rbits), **kw)
    x2, w2 = x.copy(), w.copy()
    for i, j in zip(*np.nonzero(lbits)):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = np.nan
    for i, j in zip(*np.nonzero(rbits)):
        w2[i * bk:(i + 1) * bk, j * bn:(j + 1) * bn] = np.nan
    w2[3 * bk:4 * bk] = np.nan
    y2 = sg.sparce_gemm_gated_both(*_t(x2, w2, lbits, rbits), **kw)
    assert torch.isfinite(y2).all() and torch.equal(y2, y)
    w3 = w.copy()
    w3[0, 0] = np.nan  # tile (0, 0) is live in both operands
    y3 = sg.sparce_gemm_gated_both(*_t(x, w3, lbits, rbits), **kw)
    assert torch.isnan(y3[:bm, 0]).all()


def test_gemm_wrappers_reject_bad_arguments():
    _, x, w = _operands(48, 8, 256, 128)
    xt, wt = _t(x, w)
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    kw = dict(block_m=8, block_k=128, block_n=128)
    with pytest.raises(ValueError, match="lhs bits must be"):
        sg.sparce_gemm_compacted(xt, wt, z(1, 3), **kw)
    with pytest.raises(ValueError, match="rhs bits must be"):
        sg.sparce_gemm_gated_both(xt, wt, z(1, 2), z(2, 2), **kw)
    with pytest.raises(ValueError, match="lhs bits must be"):
        sg.sparce_gemm_gated_both(xt, wt, z(2, 2), z(2, 1), **kw)
    meta = [t.to("meta") for t in (xt, wt, z(1, 2), z(2, 1))]
    with pytest.raises(ValueError, match="unsupported device"):
        sg.sparce_gemm_compacted(*meta[:3], **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        sg.sparce_gemm_gated_both(*meta, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        rb.relu_bwd_bitmap(meta[0], meta[0], block_r=1, block_c=128)
    counters = (sg.sparce_gemm_compacted, sg.sparce_gemm_gated_both,
                rb.relu_bwd_bitmap)
    before = [f.launches for f in counters]
    sg.sparce_gemm_compacted(xt, wt, z(1, 2), **kw)
    sg.sparce_gemm_gated_both(xt, wt, z(1, 2), z(2, 1), **kw)
    rb.relu_bwd_bitmap(xt, xt, block_r=8, block_c=128)
    assert [f.launches for f in counters] == before  # CPU: nothing launched


def test_ops_sparce_gemm_routes_each_plan(monkeypatch):
    """lhs compacted -> the compacted kernel; gate='both' -> the
    two-sided kernel also under a compacted plan (the reference routes it
    so); gated stays on the gated kernel. Nothing runs on the CPU path
    without going through these three entry points."""
    calls = []
    for name in ("sparce_gemm_gated", "sparce_gemm_compacted",
                 "sparce_gemm_gated_both"):
        real = getattr(sg, name)
        monkeypatch.setattr(sg, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _, x, w = _operands(49, 16, 256, 128)
    xt, wt = _t(x, w)
    lhs = TileBitmap(torch.zeros((2, 2), dtype=torch.int32), (8, 128),
                     (16, 256))
    rhs = TileBitmap(torch.zeros((2, 1), dtype=torch.int32), (128, 128),
                     (256, 128))
    blocks = dict(block_m=8, block_k=128, block_n=128)
    for gate, variant, want in (("lhs", "compacted", "sparce_gemm_compacted"),
                                ("lhs", "gated", "sparce_gemm_gated"),
                                ("rhs", "compacted", "sparce_gemm_compacted"),
                                ("both", "compacted",
                                 "sparce_gemm_gated_both"),
                                ("both", "gated", "sparce_gemm_gated_both")):
        calls.clear()
        y = kops.sparce_gemm(xt, wt, SkipPlan(gate=gate, variant=variant,
                                              **blocks),
                             lhs_bitmap=lhs, rhs_bitmap=rhs)
        assert calls == [want], (gate, variant, calls)
        np.testing.assert_allclose(y.numpy(), x @ w, **F32_TOL)


@pytest.mark.parametrize("plan_kw,want", [
    (dict(gate="lhs", variant="compacted"), "sparce_gemm_compacted"),
    (None, "sparce_gemm_gated_both"),  # both bitmaps, no plan
])
def test_sparce_matmul_kernel_mode_reaches_the_new_kernels(
        plan_kw, want, monkeypatch):
    """``sparce_matmul(mode="kernel")`` with an explicit compacted plan,
    or with both bitmaps and no plan (gate="both"), runs the new kernels
    and equals the reference's sparce_matmul."""
    calls = []
    real = getattr(sg, want)
    monkeypatch.setattr(sg, want, lambda *a, **k: (calls.append(want),
                                                   real(*a, **k))[1])
    M, K, N, bm, bk, bn = 16, 384, 256, 8, 128, 128
    rng, x, w = _operands(54, M, K, N)
    lbits = (rng.random((M // bm, K // bk)) < 0.5).astype(np.int32)
    rbits = (rng.random((K // bk, N // bn)) < 0.5).astype(np.int32)
    cfg_kw = dict(enabled=True, mode="kernel", block_m=bm, block_k=bk,
                  block_n=bn)
    lb = TileBitmap(torch.from_numpy(lbits), (bm, bk), (M, K))
    rbm = TileBitmap(torch.from_numpy(rbits), (bk, bn), (K, N))
    ref_lb = ref_sprf.TileBitmap(jnp.asarray(lbits), (bm, bk), (M, K))
    ref_rbm = ref_sprf.TileBitmap(jnp.asarray(rbits), (bk, bn), (K, N))
    if plan_kw is None:
        kw, rkw = dict(lhs_bitmap=lb, rhs_bitmap=rbm), dict(
            lhs_bitmap=ref_lb, rhs_bitmap=ref_rbm)
        plan = ref_plan = None
    else:
        kw, rkw = dict(lhs_bitmap=lb), dict(lhs_bitmap=ref_lb)
        plan = SkipPlan(block_m=bm, block_k=bk, block_n=bn, **plan_kw)
        ref_plan = ref_sasa.SkipPlan(block_m=bm, block_k=bk, block_n=bn,
                                     **plan_kw)
    got = sparse_ops.sparce_matmul(*_t(x, w), sparse_ops.SparsityConfig(
        **cfg_kw), plan, **kw)
    want_y = ref_sparse_ops.sparce_matmul(
        *_j(x, w), ref_sparse_ops.SparsityConfig(**cfg_kw), ref_plan, **rkw)
    assert calls == [want]
    np.testing.assert_allclose(got.numpy(), np.asarray(want_y), **F32_TOL)


# ------------------------------------------------------------ relu backward
@pytest.mark.parametrize("shape,block", [
    ((128, 256), (8, 128)), ((8, 1536), (1, 128)), ((64, 384), (64, 128)),
])
def test_relu_bwd_plain_matches_reference_kernel(shape, block):
    """Including NaN in g where x > 0 (passes, bit 0) and where x <= 0
    (dropped), -0.0 in g (counts as zero) and whole dead tiles."""
    rng = np.random.default_rng(50)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    br, bc = block
    x[:br, :bc] = -1.0  # tile (0, 0): x <= 0 everywhere -> dead
    g[:br, bc:2 * bc] = -0.0  # tile (0, 1): g is -0.0 -> dead
    x[-br:, -bc:] = 1.0
    g[-br:, -bc:] = 0.0
    g[-1, -1] = np.nan  # the last tile's only nonzero is a NaN
    x[0, 0], g[0, 0] = -2.0, np.nan  # dropped where x <= 0
    want_gx, want_bits = ref_rb.relu_bwd_bitmap(*_j(x, g), block_r=br,
                                                block_c=bc, interpret=True)
    gx, bits = rb.relu_bwd_bitmap(*_t(x, g), block_r=br, block_c=bc)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(want_gx))
    assert bits[0, 0] == 1 and bits[0, 1] == 1 and bits[-1, -1] == 0
    oracle_gx, oracle_bits = kref.relu_bwd_bitmap_ref(*_t(x, g), block)
    assert torch.equal(oracle_bits, bits)
    np.testing.assert_array_equal(oracle_gx.numpy(), gx.numpy())


def test_relu_bwd_bf16_matches_reference_kernel():
    rng = np.random.default_rng(51)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    g = rng.standard_normal((16, 256)).astype(np.float32)
    x[:4] = -1.0
    want_gx, want_bits = ref_rb.relu_bwd_bitmap(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
        block_r=4, block_c=128, interpret=True)
    gx, bits = rb.relu_bwd_bitmap(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(g).bfloat16(),
                                  block_r=4, block_c=128)
    assert gx.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(gx.float().numpy(),
                                  np.asarray(want_gx, np.float32))


def test_relu_bwd_with_bitmap_pads_like_reference():
    """Ragged rows and columns: padding tiles get bit 1."""
    rng = np.random.default_rng(52)
    x = rng.standard_normal((10, 300)).astype(np.float32)
    g = rng.standard_normal((10, 300)).astype(np.float32)
    x[8:] = -1.0  # row tile 1 (rows 8..15, of which 10.. are padding)
    gx, bmp = kops.relu_bwd_with_bitmap(*_t(x, g), (8, 128))
    want_gx, want_bmp = ref_ops.relu_bwd_with_bitmap(*_j(x, g), (8, 128))
    assert tuple(gx.shape) == (10, 300) and bmp.shape == (10, 300)
    np.testing.assert_array_equal(bmp.bits.numpy(), np.asarray(want_bmp.bits))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(want_gx))
    assert bmp.bits[1].all()


# --------------------------------------- the evaluation path, reduced table
BENCHES = ("alexnet", "deepcomp-alexnet", "cifar10")
PAIRS = {("none", "dense"), ("lhs", "gated"), ("lhs", "compacted"),
         ("rhs", "gated"), ("both", "compacted")}


def _reduced(layer):
    """m, k, n cut so each reduced layer keeps its full-size (gate,
    variant): m to at most 96 (a smaller m turns the deepcomp conv
    layers' rhs gate into 'both'), k / 8 and n / 4 (ragged over the
    blocks: k 300, n 250)."""
    return min(layer.m, 96), max(128, layer.k // 8), max(128, layer.n // 4)


def _bench_layers(bench):
    scale = BENCH_SPARSITY[bench] / 0.36
    for layer in REF_GEMMS:
        act = min(0.9, layer.act_sparsity * scale)
        w = (DEEPCOMP_WEIGHT_SPARSITY.get(layer.name, 0.0)
             if bench == "deepcomp-alexnet" else 0.0)
        yield layer, act, w


def _plans(m, k, n, act, w):
    kw = dict(lhs_sparsity=act, rhs_sparsity=w, lhs_cluster=8 * 128,
              rhs_cluster=64 * 128)
    return sasa.plan_matmul(m, k, n, **kw), ref_sasa.plan_matmul(m, k, n,
                                                                 **kw)


def test_reduced_table_keeps_every_plan_pair_of_the_full_table():
    full, reduced = set(), set()
    for bench in BENCHES:
        for layer, act, w in _bench_layers(bench):
            pf, _ = _plans(layer.m, layer.k, layer.n, act, w)
            pr, _ = _plans(*_reduced(layer), act, w)
            assert (pf.gate, pf.variant) == (pr.gate, pr.variant), layer
            full.add((pf.gate, pf.variant))
            reduced.add((pr.gate, pr.variant))
    assert full == reduced == PAIRS


@pytest.mark.parametrize("bench", BENCHES)
def test_alexnet_table_through_ops_matches_reference(bench):
    """Features with zeroed 8 x 128 clusters at each layer's scaled
    sparsity; weights block-pruned at the deep-compression sparsity
    (deepcomp-alexnet); plans from plan_matmul as fig14 makes them.
    Bitmaps, plans, outputs and skipped tile products equal the
    reference's kops.sparce_gemm in interpret mode."""
    rng = np.random.default_rng(53)
    for layer, act, ws in _bench_layers(bench):
        m, k, n = _reduced(layer)
        plan, ref_plan = _plans(m, k, n, act, ws)
        assert plan == bridge.plan_from_reference(ref_plan)
        bm, bk, bn = plan.block_m, plan.block_k, plan.block_n
        x = rng.standard_normal((m, k)).astype(np.float32)
        gr, gc = -(-m // 8), -(-k // 128)
        dead = rng.permutation(gr * gc)[:int(round(act * gr * gc))]
        for c in dead:
            i, j = divmod(int(c), gc)
            x[i * 8:(i + 1) * 8, j * 128:(j + 1) * 128] = 0.0
        w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        if ws:
            w = np.array(ref_sprf.prune_weights(jnp.asarray(w), ws,
                                                block=(bk, bn)))
        lb = sprf.compute_bitmap(torch.from_numpy(x), (bm, bk))
        rbm = sprf.compute_bitmap(torch.from_numpy(w), (bk, bn))
        ref_lb = ref_sprf.compute_bitmap(jnp.asarray(x), (bm, bk))
        ref_rbm = ref_sprf.compute_bitmap(jnp.asarray(w), (bk, bn))
        assert torch.equal(lb.bits, bridge.bitmap_from_reference(ref_lb).bits)
        assert torch.equal(rbm.bits,
                           bridge.bitmap_from_reference(ref_rbm).bits)
        got = kops.sparce_gemm(*_t(x, w), plan, lhs_bitmap=lb,
                               rhs_bitmap=rbm)
        want = ref_ops.sparce_gemm(*_j(x, w), ref_plan, lhs_bitmap=ref_lb,
                                   rhs_bitmap=ref_rbm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=layer.name, **F32_TOL)
        np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-4, atol=1e-4,
                                   err_msg=layer.name)  # honest bits
        assert sasa.dropped_tile_products(plan, lb.bits, rbm.bits) == \
            sasa.dropped_tile_products(ref_plan, np.asarray(ref_lb.bits),
                                       np.asarray(ref_rbm.bits))


@pytest.mark.parametrize("gate,variant,want", [
    ("none", "dense", 0), ("lhs", "dense", 0), ("lhs", "gated", 2 * 3),
    ("lhs", "compacted", 2 * 3), ("rhs", "gated", 3 * 2), ("both", "gated", 9),
    ("both", "compacted", 9)])
def test_dropped_tile_products_counts_each_gate(gate, variant, want):
    """lhs bits (2 x 2) with 2 dead tiles, rhs bits (2 x 3) with 3: the
    triples (i, k, j) each gate drops, counted by hand."""
    lbits = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    rbits = torch.tensor([[1, 1, 0], [0, 0, 1]], dtype=torch.int32)
    # both: (i=0,k=0) drops 3, (i=1,k=1) drops 3, and the live x tiles
    # (0,1) and (1,0) meet rhs bit 1 at (k=1,j=2) and (k=0,j=0..1): 1 + 2
    plan = SkipPlan(gate=gate, variant=variant, block_m=8, block_k=128,
                    block_n=128)
    assert sasa.dropped_tile_products(plan, lbits, rbits) == (want, 12)


# ------------------------------------- the k chunks of the gated kernels
# (K, block_k) pairs of the paths and tests: the relu decode and
# prefill, every AlexNet layer, ragged K, block_k 1 and 32.
CHUNK_CASES = [(1536, 128), (2400, 128), (3456, 128), (9216, 128),
               (4096, 128), (363, 128), (1000, 128), (640, 128),
               (1025, 1), (1024, 1), (700, 32), (96, 128), (1, 1)]


def _chunks(k, block_k):
    s = sg.chunk_tiles(k, block_k)
    gk = -(-k // block_k)
    return [range(c * s, min((c + 1) * s, gk))
            for c in range(sg.num_chunks(k, block_k))]


@pytest.mark.parametrize("k,block_k", CHUNK_CASES)
def test_chunks_cover_every_k_tile_once(k, block_k):
    """Chunk c holds k tiles [c*S, (c+1)*S): together they cover the
    ceil(K/block_k) tiles exactly once, in ascending order, none empty,
    at most MAX_CHUNKS of them."""
    chunks = _chunks(k, block_k)
    assert [t for c in chunks for t in c] == list(range(-(-k // block_k)))
    assert all(len(c) > 0 for c in chunks)
    assert 1 <= len(chunks) <= sg.MAX_CHUNKS


def test_chunk_size_depends_on_k_and_block_k_only():
    """S takes (K, block_k) and nothing else -- not M, N, the bits, the
    gate or the kernel -- so the gated and compacted kernels cut every
    row's sum at the same k tiles; it grows with K at fixed block_k."""
    import inspect
    assert list(inspect.signature(sg.chunk_tiles).parameters) == [
        "k", "block_k"]
    sizes = [sg.chunk_tiles(k, 128) for k in range(128, 128 * 200, 128)]
    assert sizes == sorted(sizes)
    # The shapes of the paths: relu decode 12 k tiles -> 6 chunks of 2;
    # AlexNet fc6 72 -> 8 of 9; conv4 27 -> 7 of 4.
    assert [(sg.chunk_tiles(k, 128), sg.num_chunks(k, 128))
            for k in (1536, 9216, 3456)] == [(2, 6), (9, 8), (4, 7)]


@pytest.mark.parametrize("m,k,n,block_k", [
    (8, 1536, 576, 128), (1, 9216, 4096, 128), (169, 3456, 384, 128),
    (4, 96, 64, 128), (2, 1, 8, 1)])
def test_partial_shape_is_what_the_kernels_write(m, k, n, block_k):
    """The scratch is one f32 (M, N) partial per chunk; with a single
    chunk there is none (the kernel writes y itself)."""
    nc = sg.num_chunks(k, block_k)
    want = (nc, m, n) if nc > 1 else (0,)
    assert sg.partial_shape(m, k, n, block_k) == want
    assert (nc == 1) == (sg.chunk_tiles(k, block_k) >= -(-k // block_k))


def test_both_kernels_get_the_same_chunks_and_scratch(monkeypatch):
    """The wrappers' C calls (stubbed here) pass S = chunk_tiles(K,
    block_k) to the gated and the compacted kernel alike, a scratch
    pointer exactly when there is more than one chunk, and as many
    arguments as the declared C signature."""
    from repro_torch.kernels import _build
    calls = {}

    def function(lib, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls[symbol] = args
            return 0
        return fn

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    for (m, k, n) in ((8, 1536, 576), (4, 96, 64)):
        _, x, w = _operands(60, m, k, n)
        xt, wt = _t(x, w)
        bits = torch.zeros((m, -(-k // 128)), dtype=torch.int32)
        sg._launch_gemm("sparce_gemm_gated", xt, wt, bits, None, 128, 1,
                        128, 128, 0)
        sg._launch_gemm("sparce_gemm_compacted", xt, wt, bits, None, 128,
                        1, 128)
        g, c = calls["sparce_gemm_gated"], calls["sparce_gemm_compacted"]
        assert g[-3] == c[-3] == sg.chunk_tiles(k, 128)
        assert g[5:8] == c[5:8] == (m, k, n)
        multi = sg.num_chunks(k, 128) > 1
        assert (g[4] is not None) == (c[4] is not None) == multi


def test_two_sided_kernel_gets_the_gated_chunks_whatever_the_bits(
        monkeypatch):
    """The two-sided wrapper's C call (stubbed here) gets both bit grids,
    the gated kernel's S = chunk_tiles(K, block_k) and a scratch pointer
    exactly when there is more than one chunk, as many arguments as the
    declared C signature -- and the same S and scratch for any bits:
    they are functions of the shapes only."""
    from repro_torch.kernels import _build
    calls = []

    def function(lib, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    rng = np.random.default_rng(62)
    for (m, k, n, bm, bk, bn) in ((1, 9216, 4096, 8, 128, 128),
                                  (40, 1500, 300, 16, 128, 64),
                                  (4, 96, 64, 8, 128, 128)):
        _, x, w = _operands(63, m, k, n)
        xt, wt = _t(x, w)
        kw = dict(block_m=bm, block_k=bk, block_n=bn)
        lg = sg.bit_grid(m, k, n, gate="lhs", **kw)
        rg = sg.bit_grid(m, k, n, gate="rhs", **kw)
        seen = []
        for fill in ("zeros", "ones", "random"):
            if fill == "random":
                lb, rb = ((rng.random(g) < 0.5).astype(np.int32)
                          for g in (lg, rg))
            else:
                lb, rb = (getattr(np, fill)(g, np.int32) for g in (lg, rg))
            lbt, rbt = _t(lb, rb)
            sg._launch_gemm("sparce_gemm_gated_both", xt, wt, lbt, None, bk,
                            bm, bk, bn, rbits=rbt)
            sg._launch_gemm("sparce_gemm_gated", xt, wt, lbt, None, bk, bm,
                            bk, bn, 0)
            (sb, b), (sgd, g) = calls[-2:]
            assert (sb, sgd) == ("sparce_gemm_gated_both",
                                 "sparce_gemm_gated")
            assert b[2] == lbt.data_ptr() and b[3] == rbt.data_ptr()
            assert b[6:9] == g[5:8] == (m, k, n)
            assert b[9:12] == (bm, bk, bn)
            assert b[-3] == g[-3] == sg.chunk_tiles(k, bk)
            multi = sg.num_chunks(k, bk) > 1
            assert (b[5] is not None) == (g[4] is not None) == multi
            seen.append((b[-3], b[5] is None))
        assert len(set(seen)) == 1


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (16, 1536, 64, 1, 128, 128),   # relu decode's K: 6 chunks of 2
    (24, 1000, 40, 8, 128, 128),   # ragged K: 8 chunks of 1
    (9, 700, 33, 8, 32, 64),       # block_k 32: 8 chunks of 3
])
def test_chunked_sum_equals_reference_kernel(M, K, N, bm, bk, bn):
    """The kernels' split: each chunk's partial over its live k tiles
    (the plain version with the tiles outside the chunk gated), added
    in ascending chunk order from +0, equals the Pallas kernel; a row
    tile with no live tile gets exact zeros."""
    rng, x, w = _operands(61, M, K, N)
    grid = sg.bit_grid(M, K, N, block_m=bm, block_k=bk, block_n=bn,
                       gate="lhs")
    bits = (rng.random(grid) < 0.5).astype(np.int32)
    bits[-1] = 1
    kw = dict(block_m=bm, block_k=bk, block_n=bn)
    xt, wt = _t(x, w)
    y = torch.zeros((M, N))
    for chunk in _chunks(K, bk):
        cb = np.ones_like(bits)
        cb[:, chunk.start:chunk.stop] = bits[:, chunk.start:chunk.stop]
        y = y + sg.sparce_gemm_gated_plain(xt, wt, torch.from_numpy(cb),
                                           gate="lhs", **kw)
    # The Pallas kernel takes padded dims: the zero-padded product's
    # [:M, :N] is the kernels' contract.
    pm, pk, pn = (-(-d // b) * b for d, b in ((M, bm), (K, bk), (N, bn)))
    xp = np.pad(x, ((0, pm - M), (0, pk - K)))
    wp = np.pad(w, ((0, pk - K), (0, pn - N)))
    want = ref_sg.sparce_gemm_compacted(*_j(xp, wp, bits), interpret=True,
                                        **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(want)[:M, :N],
                               **F32_TOL)
    assert float(y[(grid[0] - 1) * bm:].abs().max()) == 0.0
