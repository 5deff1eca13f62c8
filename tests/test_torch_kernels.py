"""The port's kernels: plain versions against the reference kernels,
and the skip contracts. (The CUDA kernels against the plain versions,
on a GPU, are in test_torch_gpu.py, which does not import the
reference's framework.)

On the CPU every wrapper runs its kernel's plain PyTorch version; the
reference kernels run in Pallas interpret mode, as the reference's own
tests run them. Inputs come from numpy seeds and go to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import paged_decode_attn as ref_pda
from repro.kernels import ref as ref_kref
from repro.kernels import sparce_glu_mlp as ref_sgm
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_decode_attn as pda
from repro_torch.kernels import ref as kref
from repro_torch.kernels import sparce_glu_mlp as sgm

BS = 4  # pool rows per block in the attention tests
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32, sums in another order


def _tables(rng, lengths, max_blocks, nb, bs=BS, dead_fill=0):
    """Non-overlapping random live blocks; entries past each live prefix
    hold ``dead_fill``."""
    B = len(lengths)
    tables = np.full((B, max_blocks), dead_fill, np.int32)
    ids = rng.permutation(np.arange(1, nb))
    nxt = 0
    for b in range(B):
        live = -(-int(lengths[b]) // bs)
        tables[b, :live] = ids[nxt:nxt + live]
        nxt += live
    return tables


def _attn_case(seed, lengths, max_blocks=6, KV=2, g=2, D=16, dead_fill=0):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    nb = B * max_blocks + 1
    q = rng.standard_normal((B, KV, g, D)).astype(np.float32)
    kp = rng.standard_normal((nb, BS, KV, D)).astype(np.float32)
    vp = rng.standard_normal((nb, BS, KV, D)).astype(np.float32)
    tables = _tables(rng, lengths, max_blocks, nb, dead_fill=dead_fill)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------ paged attention
@pytest.mark.parametrize("lengths", [
    [1, 9, 24, 13],  # ragged, mid-block
    [8, 16, 4, 12],  # exact block edges
    [1, 1, 1, 1],    # first-tick prompts
    [24, 0, 7, 0],   # dead slots interleaved
])
def test_paged_attn_plain_matches_reference_kernel(lengths):
    q, kp, vp, tables, ln = _attn_case(0, lengths)
    want = np.asarray(ref_pda.paged_gqa_decode_attn(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ln), interpret=True))
    got = pda.paged_gqa_decode_attn(*_t(q, kp, vp, tables, ln)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    oracle = np.asarray(ref_kref.paged_gqa_decode_attn_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ln)))
    live = ln > 0
    np.testing.assert_allclose(got[live], oracle[live], **F32_TOL)
    port_oracle = kref.paged_gqa_decode_attn_ref(
        *_t(q, kp, vp, tables, ln)).numpy()
    np.testing.assert_allclose(port_oracle[live], oracle[live], **F32_TOL)
    assert np.all(got[~live] == 0.0)  # nothing fetched, zeros written


@pytest.mark.parametrize("max_blocks", [1, 3, 5, 7])
def test_paged_attn_ragged_table_widths(max_blocks):
    L = max_blocks * BS
    lengths = [min(L, v) for v in (1, L, max(1, L - 2), L // 2 + 1)]
    q, kp, vp, tables, ln = _attn_case(2, lengths, max_blocks=max_blocks,
                                       D=24)
    want = np.asarray(ref_ops.paged_decode_attn(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ln), feat_align=128))
    got = kops.paged_decode_attn(*_t(q, kp, vp, tables, ln)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_paged_attn_clamps_lengths_to_table_reach():
    """Lengths past max_blocks * bs clamp to the table's reach, as the
    reference wrapper does."""
    q, kp, vp, tables, ln = _attn_case(3, [24, 5], max_blocks=6)
    over = ln.copy()
    over[0] = 1000
    want = np.asarray(ref_ops.paged_decode_attn(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(over)))
    got = kops.paged_decode_attn(*_t(q, kp, vp, tables, over)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_paged_attn_lengths_past_the_table_read_only_the_table():
    """Without the wrapper's clamp, a length past the table's reach
    still reads only the slot's own table row (the kernel caps its loop
    at the table width, and so does the plain version)."""
    q, kp, vp, tables, ln = _attn_case(9, [24, 5], max_blocks=6)
    over = ln.copy()
    over[0] = 1000
    got = pda.paged_gqa_decode_attn(*_t(q, kp, vp, tables, over))
    want = pda.paged_gqa_decode_attn(*_t(q, kp, vp, tables, ln))
    assert torch.equal(got, want)
    assert [len(i) for i in pda.live_block_ids(tables, over, BS)] == [6, 2]


def test_paged_attn_nan_poisoned_dead_blocks_never_read():
    """Every block outside the live prefixes is NaN, and dead table
    entries name poisoned blocks: the output is bit-identical."""
    q, kp, vp, tables, ln = _attn_case(4, [9, 0, 24, 3])
    base = pda.paged_gqa_decode_attn(*_t(q, kp, vp, tables, ln))
    live_ids = {int(i) for ids in pda.live_block_ids(tables, ln, BS)
                for i in ids}
    dead = np.array([i for i in range(kp.shape[0]) if i not in live_ids])
    kp2, vp2, tbl2 = kp.copy(), vp.copy(), tables.copy()
    kp2[dead] = np.nan
    vp2[dead] = np.nan
    for b, n in enumerate(ln):
        tbl2[b, -(-int(n) // BS):] = dead[b % len(dead)]
    poisoned = pda.paged_gqa_decode_attn(*_t(q, kp2, vp2, tbl2, ln))
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, base)


def test_paged_attn_masks_rows_past_length_in_last_block():
    q, kp, vp, tables, ln = _attn_case(5, [6, 2])
    base = pda.paged_gqa_decode_attn(*_t(q, kp, vp, tables, ln))
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(2):
        last = tables[b, (int(ln[b]) - 1) // BS]
        kp2[last, int(ln[b]) % BS:] = 1e9
        vp2[last, int(ln[b]) % BS:] = -1e9
    got = pda.paged_gqa_decode_attn(*_t(q, kp2, vp2, tables, ln))
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_live_block_ids_are_the_exact_loads():
    """Host-side skip contract: the kernel loads exactly table entries
    [0, ceil(len/bs)) of each slot -- nothing for a dead slot, no entry
    past the prefix -- and every one of them is a block the reference's
    clamped index map also names. Poisoning ONE live block poisons
    exactly its slot, so each listed load really happens."""
    B, max_blocks = 5, 8
    lengths = np.array([0, 1, BS, 3 * BS - 1, max_blocks * BS], np.int32)
    rng = np.random.default_rng(6)
    tables = _tables(rng, lengths, max_blocks, B * max_blocks + 1,
                     dead_fill=10_000)
    ids = pda.live_block_ids(tables, lengths, BS)
    ref_ids = ref_pda.clamped_block_ids(tables, lengths, BS)
    for b in range(B):
        nblk = -(-int(lengths[b]) // BS)
        assert ids[b].tolist() == tables[b, :nblk].tolist()
        assert 10_000 not in ids[b].tolist()
        if nblk:
            assert set(ids[b].tolist()) == set(ref_ids[b].tolist())
    np.testing.assert_array_equal(
        pda.clamped_block_ids(tables, lengths, BS), ref_ids)
    q, kp, vp, tables, ln = _attn_case(7, [9, 13, 5])
    for b in range(3):
        kp2 = kp.copy()
        kp2[pda.live_block_ids(tables, ln, BS)[b][-1]] = np.nan
        out = pda.paged_gqa_decode_attn(*_t(q, kp2, vp, tables, ln))
        nan_slots = torch.isnan(out).flatten(1).any(dim=1)
        assert nan_slots.tolist() == [i == b for i in range(3)]


def test_block_counting_equals_reference():
    for lengths, mb, bs in (([0, 1, 8, 9], 6, 4), ([16, 17, 0], 3, 16),
                            ([], 6, 4), ([5], 1, 8)):
        assert pda.decode_attn_block_counts(lengths, mb, bs) == \
            ref_pda.decode_attn_block_counts(lengths, mb, bs)
        assert pda.decode_attn_savings(lengths, mb, bs) == \
            ref_pda.decode_attn_savings(lengths, mb, bs)


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    q, kp, vp, tables, ln = _attn_case(8, [3, 0])
    before = pda.paged_gqa_decode_attn.launches
    pda.paged_gqa_decode_attn(*_t(q, kp, vp, tables, ln))
    assert pda.paged_gqa_decode_attn.launches == before  # nothing launched
    meta = [t.to("meta") for t in _t(q, kp, vp, tables, ln)]
    with pytest.raises(ValueError, match="unsupported device"):
        pda.paged_gqa_decode_attn(*meta)
    x = torch.zeros((4, 8), device="meta")
    w = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sgm.sparce_glu_mlp_fused(x, w, w, w, block_m=4, block_f=8)


# ------------------------------------------------------------ gated GLU
def _glu_case(seed, M=64, K=128, F=256, N=128, zero_rows=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if zero_rows is not None:
        x[zero_rows] = 0.0
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((K, F), (K, F), (F, N))]
    return [x] + w


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_glu_plain_matches_reference_kernel(act, tau):
    bm, bf = 16, 128
    x, wg, wi, wo = _glu_case(0, zero_rows=slice(16, 32))
    y_ref, bits_ref = ref_sgm.sparce_glu_mlp_fused(
        *map(jnp.asarray, (x, wg, wi, wo)), block_m=bm, block_f=bf, act=act,
        tau=tau, interpret=True)
    y, bits = sgm.sparce_glu_mlp_fused(*_t(x, wg, wi, wo), block_m=bm,
                                       block_f=bf, act=act, tau=tau)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_ref))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32_TOL)
    assert bits.numpy()[1].all()  # the zero row tile is dead across F
    want, want_bits = kref.glu_mlp_ref(*_t(x, wg, wi, wo), act=act, tau=tau,
                                       block_m=bm, block_f=bf)
    np.testing.assert_array_equal(bits.numpy(), want_bits.numpy())
    np.testing.assert_allclose(y.numpy(), want.numpy(), **F32_TOL)


def test_glu_padded_wrapper_matches_reference():
    """Ragged M and F: the padded rows and columns vote dead on both
    sides, so the bits and values equal the reference's."""
    x, wg, wi, wo = _glu_case(1, M=20, K=64, F=200, N=48)
    y_ref, bmp_ref = ref_ops.sparce_glu_mlp_fused(
        *map(jnp.asarray, (x, wg, wi, wo)), block_m=16, block_f=128,
        tau=0.0, interpret=True)
    y, bmp = kops.sparce_glu_mlp_fused(*_t(x, wg, wi, wo), block_m=16,
                                       block_f=128)
    np.testing.assert_array_equal(bmp.bits.numpy(), np.asarray(bmp_ref.bits))
    assert bmp.shape == (20, 200) and tuple(bmp.bits.shape) == (2, 2)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32_TOL)


def test_glu_nan_poisoned_dead_stripes_never_read():
    """Dead stripes' w_in columns AND w_out rows are NaN: y and bits are
    bit-identical, so neither stripe was read. Poisoning a LIVE stripe
    does reach y, so the live loads are real."""
    bm, bf = 16, 64
    x, wg, wi, wo = _glu_case(2, M=32, F=256)
    wg[:, bf:2 * bf] = 0.0  # stripe 1 dead in every row tile
    wg[:, 3 * bf:] = 0.0  # stripe 3 dead too
    y, bits = sgm.sparce_glu_mlp_fused(*_t(x, wg, wi, wo), block_m=bm,
                                       block_f=bf)
    dead = bits.bool().all(dim=0).nonzero().flatten().tolist()
    assert dead == [1, 3]
    wi2, wo2 = wi.copy(), wo.copy()
    for f in dead:
        wi2[:, f * bf:(f + 1) * bf] = np.nan
        wo2[f * bf:(f + 1) * bf] = np.nan
    y2, bits2 = sgm.sparce_glu_mlp_fused(*_t(x, wg, wi2, wo2), block_m=bm,
                                         block_f=bf)
    assert torch.isfinite(y2).all()
    assert torch.equal(y2, y) and torch.equal(bits2, bits)
    wi3 = wi.copy()
    wi3[0, 0] = np.nan  # stripe 0 is live
    y3, _ = sgm.sparce_glu_mlp_fused(*_t(x, wg, wi3, wo), block_m=bm,
                                     block_f=bf)
    assert torch.isnan(y3).any()


def test_glu_rejects_bad_arguments():
    x, wg, wi, wo = _t(*_glu_case(3, M=16))
    with pytest.raises(ValueError, match="act"):
        sgm.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=16, block_f=128,
                                 act="tanh")
    with pytest.raises(ValueError, match="threshold"):
        sgm.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=16, block_f=128,
                                 tau=-1.0)
    with pytest.raises(ValueError, match="padded"):
        sgm.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=12, block_f=128)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "relu2"])
def test_glu_act_and_bitmap_oracles_match_reference(act):
    rng = np.random.default_rng(9)
    g = rng.standard_normal((40, 200)).astype(np.float32)
    g[:16] = 0.0
    ga = kref.glu_act_ref(torch.from_numpy(g), act)
    ga_ref = ref_kref.glu_act_ref(jnp.asarray(g), act)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ga_ref), rtol=1e-6,
                               atol=1e-6)
    for tau in (0.0, 0.05):
        np.testing.assert_array_equal(
            kref.gate_bitmap_ref(ga, (16, 64), tau).numpy(),
            np.asarray(ref_kref.gate_bitmap_ref(ga_ref, (16, 64), tau)))


def test_sparce_gemm_ref_matches_reference():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((48, 64)).astype(np.float32)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    bl = rng.integers(0, 2, (3, 2)).astype(np.int32)
    br = rng.integers(0, 2, (2, 2)).astype(np.int32)
    got = kref.sparce_gemm_ref(*_t(x, w), bits_lhs=torch.from_numpy(bl),
                               bits_rhs=torch.from_numpy(br), block_m=16,
                               block_k=32, block_n=32)
    want = ref_kref.sparce_gemm_ref(
        jnp.asarray(x), jnp.asarray(w), bits_lhs=jnp.asarray(bl),
        bits_rhs=jnp.asarray(br), block_m=16, block_k=32, block_n=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("shape,block", [((48, 64), (16, 32)),
                                         ((37, 50), (16, 32)),
                                         ((8, 128), (1, 128))])
def test_compute_bitmap_matches_reference(shape, block):
    from repro.core import sprf as ref_sprf
    from repro_torch.core import sprf
    rng = np.random.default_rng(13)
    x = rng.standard_normal(shape).astype(np.float32)
    x[: shape[0] // 2, : shape[1] // 2] = 0.0
    got = sprf.compute_bitmap(torch.from_numpy(x), block)
    want = ref_sprf.compute_bitmap(jnp.asarray(x), block)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert (got.block, got.shape) == (want.block, want.shape)
