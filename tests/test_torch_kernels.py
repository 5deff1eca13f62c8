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

from repro.core.sasa import SkipPlan as RefSkipPlan
from repro.core.sprf import TileBitmap as RefTileBitmap
from repro.kernels import ops as ref_ops
from repro.kernels import paged_decode_attn as ref_pda
from repro.kernels import ref as ref_kref
from repro.kernels import relu_bitmap as ref_rb
from repro.kernels import sparce_gemm as ref_sg
from repro.kernels import sparce_glu_mlp as ref_sgm
from repro.kernels import sparce_mlp as ref_sm
from repro_torch.core.sasa import SkipPlan
from repro_torch.core.sprf import TileBitmap
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_decode_attn as pda
from repro_torch.kernels import ref as kref
from repro_torch.kernels import relu_bitmap as rb
from repro_torch.kernels import sparce_gemm as sg
from repro_torch.kernels import sparce_glu_mlp as sgm
from repro_torch.kernels import sparce_mlp as sm
from test_torch_gpu import relu_bwd_ragged_operands

BS = 4  # pool rows per block in the attention tests
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32, sums in another order
# f32 products over a few hundred terms of values up to ~1e2, summed in
# another order (the reference's own kernel tests use the same bound).
GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 products: both sides accumulate in f32 in another order and round
# the output to bf16 (8 bits of mantissa), so one ulp of values ~1-4.
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


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


@pytest.mark.parametrize("B,KV,max_blocks,bs", [
    (8, 3, 32, 16),     # smollm's decode shape
    (8, 3, 33, 16),     # a table width past the grid aim
    (1, 8, 4096, 16),   # one slot, a long table, two head groups
    (8, 5, 32, 16),     # five KV heads in two groups of three
    (2, 1, 65536, 1),   # a table past a chunk's shared entries
    (3, 3, 0, 16),      # no table
])
def test_gqa_chunks_are_a_function_of_the_shapes(B, KV, max_blocks, bs):
    """The GQA kernel's chunks and f32 scratch follow from the shapes
    alone: S chunks of E entries cover the table with no empty chunk at
    a full table, E stays within the kernel's shared entries, the head
    groups hold at most 4 KV heads as evenly as possible, and the walk
    has S chunks a slot whatever the lengths."""
    s, e = pda.gqa_chunks(B, KV, max_blocks, bs)
    assert s * e >= max(max_blocks, 1) and (s - 1) * e < max(max_blocks, 1)
    assert 1 <= e <= pda.GQA_MAX_CHUNK_ENTRIES
    groups, hpc = pda.gqa_head_groups(KV)
    assert hpc <= pda.GQA_HEADS_PER_CTA and groups * hpc >= KV
    assert (groups - 1) * hpc < KV
    grid = pda.gqa_grid(B, KV, max_blocks, bs)
    assert grid == dict(chunks=s, entries=e, head_groups=groups, warps=hpc,
                        ctas=groups * B * s)
    assert pda.gqa_scratch_shape(B, KV, 3, 64, max_blocks, bs) == (
        B, s, KV, 3, 72)
    for lengths in ([0] * B, [max_blocks * bs] * B, [1] * B):
        walk = pda.gqa_chunk_walk(np.zeros((B, max_blocks), np.int32),
                                  np.asarray(lengths), bs, KV)
        assert [len(w) for w in walk] == [s] * B
    assert pda.gqa_chunks(B, KV, max_blocks, bs) == (s, e)


def test_gqa_grid_at_the_engine_shape():
    """At smollm's decode shape (8 slots, 3 KV heads, 32 entries of 16
    rows) the launch has 128 CTAs of 3 warps, 16 chunks of 2 entries a
    slot -- about one CTA per SM, where the first design ran 24 (one per
    slot and KV head)."""
    grid = pda.gqa_grid(8, 3, 32, 16)
    assert grid == dict(chunks=16, entries=2, head_groups=1, warps=3,
                        ctas=128)
    assert grid["ctas"] > 8 * 3


@pytest.mark.parametrize("lengths", [
    [0, 1, 16, 17, 512, 600, 15, 33],  # 0, 1, a block edge, past the table
    [1, 17, 300, 0, 0, 511, 16, 32],   # trailing chunks empty
    [0] * 8,                           # nothing live
])
@pytest.mark.parametrize("max_blocks", [32, 33])
def test_gqa_chunk_walk_reads_exactly_the_live_blocks(lengths, max_blocks):
    """Host-side skip contract of the chunked GQA kernel: over its chunks
    a slot reads exactly ``live_block_ids`` in order (a length past the
    table reads the whole table), no chunk reads more than E entries,
    and a chunk at or past the live count reads none."""
    B, KV, bs = 8, 3, 16
    rng = np.random.default_rng(8)
    tables = rng.permutation(np.arange(1, B * max_blocks + 1)).reshape(
        B, max_blocks).astype(np.int32)
    s, e = pda.gqa_chunks(B, KV, max_blocks, bs)
    walk = pda.gqa_chunk_walk(tables, np.asarray(lengths), bs, KV)
    live = pda.live_block_ids(tables, np.minimum(lengths, max_blocks * bs),
                              bs)
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(np.concatenate(walk[b]), live[b])
        nblk = pda.live_block_count(n, bs, max_blocks)
        assert len(live[b]) == nblk
        for ci, got in enumerate(walk[b]):
            assert len(got) <= e
            if ci * e >= nblk:
                assert len(got) == 0


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
    bits = torch.zeros((4, 1), dtype=torch.int32, device="meta")
    for call in (
        lambda: sgm.sparce_glu_mlp_fused(x, w, w, w, block_m=4, block_f=8),
        lambda: sm.sparce_mlp_fused(x, w, w, block_m=4, block_f=8),
        lambda: rb.relu_bitmap(x, block_r=1, block_c=8),
        lambda: sg.sparce_gemm_gated(x, w, bits, block_m=1, block_k=8,
                                     block_n=8),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    counters = (sm.sparce_mlp_fused, rb.relu_bitmap, sg.sparce_gemm_gated)
    before = [f.launches for f in counters]
    xc = torch.ones((4, 8))
    sm.sparce_mlp_fused(xc, xc.T.contiguous(), xc, block_m=4, block_f=4)
    rb.relu_bitmap(xc, block_r=1, block_c=8)
    sg.sparce_gemm_gated(xc, xc.T.contiguous(),
                         torch.zeros((4, 1), dtype=torch.int32), block_m=1,
                         block_k=8, block_n=8)
    assert [f.launches for f in counters] == before  # nothing launched


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
    with pytest.raises(ValueError, match="blocks"):
        sgm.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=0, block_f=128)
    with pytest.raises(ValueError, match="shape mismatch"):
        sgm.sparce_glu_mlp_fused(x, wg, wi[:, :64], wo, block_m=16,
                                 block_f=128)


@pytest.mark.parametrize("act", ["silu", "relu"])
@pytest.mark.parametrize("tau", [0.0, 0.05])
@pytest.mark.parametrize("M,F,bm,bf", [
    (8, 320, 64, 128),   # decode rows under a 64-row tile; ragged F
    (20, 200, 16, 128),  # ragged M and F
    (8, 256, 1, 64),     # per-row tiles
])
def test_glu_plain_at_ragged_dims_matches_reference(act, tau, M, F, bm, bf):
    """The plain version takes M and F that are not block multiples: its
    bits equal the padded reference wrapper's (interpret mode) and y is
    within the f32 tolerance; the zero rows are dead in every stripe."""
    x, wg, wi, wo = _glu_case(10, M=M, K=64, F=F, N=48, zero_rows=[1, 5])
    wg[:, bf:2 * bf] = 0.0  # a stripe dead at any tau
    wg[:, -(F % bf or bf):] *= 1e-3  # the ragged stripe dead at tau 0.05
    y_ref, bmp_ref = ref_ops.sparce_glu_mlp_fused(
        *map(jnp.asarray, (x, wg, wi, wo)), block_m=bm, block_f=bf, act=act,
        tau=tau, interpret=True)
    y, bits = sgm.sparce_glu_mlp_fused(*_t(x, wg, wi, wo), block_m=bm,
                                       block_f=bf, act=act, tau=tau)
    assert tuple(bits.shape) == sgm.bit_grid(M, F, block_m=bm, block_f=bf)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bmp_ref.bits))
    assert bits.numpy()[:, 1].all()
    if bm == 1:
        assert bits.numpy()[[1, 5]].all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32_TOL)


def test_glu_ops_wrapper_hands_the_kernel_unpadded_operands(monkeypatch):
    """ops.sparce_glu_mlp_fused pads nothing: the kernel entry gets x and
    the weights at their own shapes (8 decode rows under 64-row tiles, a
    ragged F), and y and the bitmap come back as the entry made them."""
    x, wg, wi, wo = _t(*_glu_case(11, M=8, K=64, F=200, N=48))
    seen = []

    def entry(*args, **kw):
        seen.append([tuple(a.shape) for a in args])
        return sgm.sparce_glu_mlp_fused_plain(*args, **kw)

    monkeypatch.setattr(sgm, "sparce_glu_mlp_fused", entry)
    y, bmp = kops.sparce_glu_mlp_fused(x, wg, wi, wo, block_m=64,
                                       block_f=128)
    assert seen == [[(8, 64), (64, 200), (64, 200), (200, 48)]]
    assert tuple(y.shape) == (8, 48) and tuple(bmp.bits.shape) == (1, 2)
    assert bmp.shape == (8, 200) and bmp.block == (64, 128)
    want, want_bits = sgm.sparce_glu_mlp_fused_plain(x, wg, wi, wo,
                                                     block_m=64, block_f=128)
    assert torch.equal(y, want) and torch.equal(bmp.bits, want_bits)


def test_glu_ragged_plain_never_reads_dead_stripes_or_past_the_ends():
    """The operands are views of larger buffers holding NaN past M (x's
    rows), past F (w_gate's and w_in's columns, w_out's rows) and in the
    dead stripes' w_in columns and w_out rows: y and the bits equal the
    clean run's, so none of it was read."""
    M, K, F, N, bm, bf = 10, 64, 200, 48, 16, 64
    x, wg, wi, wo = _glu_case(12, M=M, K=K, F=F, N=N)
    wg[:, bf:2 * bf] = 0.0  # stripe 1 dead in every row tile
    y, bits = sgm.sparce_glu_mlp_fused(*_t(x, wg, wi, wo), block_m=bm,
                                       block_f=bf)
    assert bits.numpy()[:, 1].all() and not bits.numpy().all()

    def poisoned(a, rows, cols):
        buf = np.full((rows, cols), np.nan, np.float32)
        buf[:a.shape[0], :a.shape[1]] = a
        return torch.from_numpy(buf)

    wi2, wo2 = wi.copy(), wo.copy()
    wi2[:, bf:2 * bf] = np.nan
    wo2[bf:2 * bf] = np.nan
    xp = poisoned(x, M + 6, K)[:M]
    wgp = poisoned(wg, K, F + 56)[:, :F]
    wip = poisoned(wi2, K, F + 56)[:, :F]
    wop = poisoned(wo2, F + 56, N)[:F]
    y2, bits2 = sgm.sparce_glu_mlp_fused(xp, wgp, wip, wop, block_m=bm,
                                         block_f=bf)
    assert torch.isfinite(y2).all()
    assert torch.equal(y2, y) and torch.equal(bits2, bits)


@pytest.mark.parametrize("m,fdim,n,bf", [(8, 1536, 576, 128),
                                         (100, 320, 70, 128)])
def test_glu_scratch_is_a_function_of_the_shapes(m, fdim, n, bf):
    """The f32 scratch the wrapper allocates is one unpadded (M, N)
    partial per stripe, whatever block_m and the bits are; the bit grid
    is ceil(M/block_m) x ceil(F/block_f), the plain version's."""
    nf = -(-fdim // bf)
    for bm in (1, 16, 64, 256):
        assert sgm.partial_shape(m, fdim, n, block_f=bf) == (nf, m, n)
        assert sgm.bit_grid(m, fdim, block_m=bm, block_f=bf) == (
            -(-m // bm), nf)
    x, wg, wi, wo = _t(*_glu_case(13, M=m, K=32, F=fdim, N=n))
    for zero in (False, True):
        wgz = torch.zeros_like(wg) if zero else wg
        _, bits = sgm.sparce_glu_mlp_fused(x, wgz, wi, wo, block_m=64,
                                           block_f=bf)
        assert bool(bits.all()) == zero
        assert tuple(bits.shape) == sgm.bit_grid(m, fdim, block_m=64,
                                                 block_f=bf)


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


# ------------------------------------------------------------ relu bitmap
@pytest.mark.parametrize("shape,block", [
    ((128, 256), (8, 128)), ((64, 512), (16, 128)), ((8, 128), (1, 32)),
])
def test_relu_bitmap_plain_matches_reference_kernel(shape, block):
    rng = np.random.default_rng(20)
    x = rng.standard_normal(shape).astype(np.float32)
    x[: block[0], : block[1]] = -np.abs(x[: block[0], : block[1]])  # dead
    x[-block[0]:, -block[1]:] = 0.0  # dead (zeros)
    want_y, want_bits = ref_rb.relu_bitmap(
        jnp.asarray(x), block_r=block[0], block_c=block[1], interpret=True)
    y, bits = rb.relu_bitmap(torch.from_numpy(x), block_r=block[0],
                             block_c=block[1])
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    assert bits[0, 0] == 1 and bits[-1, -1] == 1 and bits.sum() < bits.numel()
    oy, obits = kref.relu_bitmap_ref(torch.from_numpy(x), block)
    ry, rbits = ref_kref.relu_bitmap_ref(jnp.asarray(x), block)
    np.testing.assert_array_equal(oy.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(obits.numpy(), np.asarray(rbits))


@pytest.mark.parametrize("shape,block", [
    ((7, 300), (1, 128)),     # ragged columns, one-row tiles
    ((130, 200), (64, 128)),  # ragged rows and columns, tall tiles
    ((3, 1000), (2, 700)),    # a tile wider than the columns left
    ((8, 1536), (1, 128)),    # aligned: the decode shape
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_relu_bitmap_plain_at_ragged_dims_matches_reference(shape, block,
                                                            dtype):
    """The port's relu_bitmap takes ragged dims unpadded: y and the bits
    over ceil(R/br) x ceil(C/bc) tiles equal the reference's
    ``ops.relu_with_bitmap`` (which pads, runs its Pallas kernel in
    interpret mode and slices), with whole dead tiles, zero rows and a
    NaN in x."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal(shape).astype(np.float32)
    br, bc = block
    x[:br, :bc] = -np.abs(x[:br, :bc])  # dead
    x[shape[0] // 2] = 0.0
    x[-1, 0] = np.nan
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).bfloat16()
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    y, bits = rb.relu_bitmap(xt, block_r=br, block_c=bc)
    ry, rbmp = ref_ops.relu_with_bitmap(xj, block, interpret=True)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ry.astype(jnp.float32)))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rbmp.bits))
    assert tuple(bits.shape) == (-(-shape[0] // br), -(-shape[1] // bc))
    assert bits[0, 0] == 1
    y0, bits0 = kref.relu_bitmap_ref(xt, block)
    assert torch.equal(bits, bits0)


def test_relu_bitmap_plain_passes_nan_and_negative_zero():
    """y = x < 0 ? 0 : x, the kernel's writeback: NaN and -0.0 pass
    through bit for bit, and neither counts as > 0."""
    x = torch.tensor([[-0.0, float("nan"), -1.0, 2.0]])
    y, bits = rb.relu_bitmap(x, block_r=1, block_c=2)
    want = torch.tensor([[-0.0, float("nan"), 0.0, 2.0]])
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    assert bits.tolist() == [[1, 0]]


def test_relu_bitmap_grid_covers_several_tiles_a_cta():
    """The kernel's launch (relu and its backward) is a function of the
    shapes: a CTA takes the elements one 16-byte vector a thread covers,
    so the 96 one-row tiles of the decode shape go to 16 CTAs of up to 8
    and the 3072 of a 256-row prefill to 512 (one CTA a tile made 3072);
    a larger tile goes in slabs of rows, one a CTA (alexnet conv1's
    3025 x 96 f32 output at tile (256, 128): 768 CTAs of 4 rows, where
    one CTA a tile made 12); the bit grid is ceil(R/br) x ceil(C/bc)."""
    bf16 = torch.bfloat16
    assert rb.relu_bitmap_grid(8, 1536, 1, 128, bf16) == dict(
        bits=(8, 12), tiles_per_cta=8, rows_per_cta=1, ctas=16)
    assert rb.relu_bitmap_grid(256, 1536, 1, 128, bf16) == dict(
        bits=(256, 12), tiles_per_cta=8, rows_per_cta=1, ctas=512)
    assert rb.relu_bitmap_grid(256, 1536, 1, 128, torch.float32) == dict(
        bits=(256, 12), tiles_per_cta=4, rows_per_cta=1, ctas=768)
    assert rb.relu_bitmap_grid(7, 300, 1, 128, bf16) == dict(
        bits=(7, 3), tiles_per_cta=3, rows_per_cta=1, ctas=7)
    assert rb.relu_bitmap_grid(1, 128, 1, 128, bf16) == dict(
        bits=(1, 1), tiles_per_cta=1, rows_per_cta=1, ctas=1)
    assert rb.relu_bitmap_grid(130, 200, 64, 128, bf16) == dict(
        bits=(3, 2), tiles_per_cta=1, rows_per_cta=8, ctas=48)
    assert rb.relu_bitmap_grid(3025, 96, 256, 128, torch.float32) == dict(
        bits=(12, 1), tiles_per_cta=1, rows_per_cta=4, ctas=768)
    assert rb.relu_bitmap_grid(64, 256, 4, 128, bf16) == dict(
        bits=(16, 2), tiles_per_cta=2, rows_per_cta=4, ctas=16)
    wide = rb.relu_bitmap_grid(1, 1 << 20, 1, 1, bf16)
    assert wide["tiles_per_cta"] == rb.RELU_MAX_TILES_PER_CTA


def test_relu_ops_wrapper_hands_the_kernel_unpadded_operands(monkeypatch):
    """ops.relu_with_bitmap pads nothing: the kernel entry gets x at its
    own shape (8 decode rows under 64-row tiles, 200 columns under
    128-column tiles), and y and the bits come back as the entry made
    them."""
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (8, 200)).astype(np.float32))
    seen = []

    def entry(x, **kw):
        seen.append((tuple(x.shape), kw))
        return rb.relu_bitmap_plain(x, **kw)

    monkeypatch.setattr(rb, "relu_bitmap", entry)
    y, bmp = kops.relu_with_bitmap(x, (64, 128))
    assert seen == [((8, 200), dict(block_r=64, block_c=128))]
    want, want_bits = rb.relu_bitmap_plain(x, block_r=64, block_c=128)
    assert torch.equal(y, want) and torch.equal(bmp.bits, want_bits)
    assert tuple(bmp.bits.shape) == (1, 2)
    assert (bmp.block, bmp.shape) == ((64, 128), (8, 200))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block", [
    ((7, 300), (1, 128)), ((10, 300), (8, 128)), ((3025, 96), (8, 128)),
])
def test_relu_bwd_takes_ragged_shapes_like_the_padded_reference(
        shape, block, dtype):
    """The backward takes any shape unpadded: gx and the bits equal the
    reference's padded ``ops.relu_bwd_with_bitmap`` (its Pallas kernel
    in interpret mode): NaN in g dropped where x <= 0 and passed where
    x > 0, -0.0 counted as zero, edge tiles' padding as zero."""
    x, g, second = relu_bwd_ragged_operands(shape, block, seed=53)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want_gx, want = ref_ops.relu_bwd_with_bitmap(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), block)
    xt, gt = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, g))
    gx, bmp = kops.relu_bwd_with_bitmap(xt, gt, block)
    assert gx.dtype == gt.dtype and tuple(gx.shape) == shape
    np.testing.assert_array_equal(bmp.bits.numpy(), np.asarray(want.bits))
    np.testing.assert_array_equal(gx.float().numpy(),
                                  np.asarray(want_gx, np.float32))
    assert (bmp.block, bmp.shape) == (want.block, want.shape)
    assert bmp.bits[0, 0] == 1 and bmp.bits[second] == 1
    assert bmp.bits[-1, -1] == 0 and int(torch.isnan(gx).sum()) == 1


def test_relu_bwd_ops_wrapper_hands_the_kernel_unpadded_operands(
        monkeypatch):
    """ops.relu_bwd_with_bitmap pads and slices nothing: the kernel entry
    gets x and g at their own shape (10 rows under 8-row tiles, 300
    columns under 128-column tiles), and gx comes back dense, as the
    entry made it."""
    x, g, _ = relu_bwd_ragged_operands((10, 300), (8, 128), seed=54)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    seen = []

    def entry(x, g, **kw):
        seen.append((tuple(x.shape), tuple(g.shape), kw))
        return rb.relu_bwd_bitmap_plain(x, g, **kw)

    monkeypatch.setattr(rb, "relu_bwd_bitmap", entry)
    gx, bmp = kops.relu_bwd_with_bitmap(xt, gt, (8, 128))
    assert seen == [((10, 300), (10, 300), dict(block_r=8, block_c=128))]
    assert gx.is_contiguous() and tuple(gx.shape) == (10, 300)
    want, want_bits = rb.relu_bwd_bitmap_plain(xt, gt, block_r=8,
                                               block_c=128)
    assert torch.equal(torch.nan_to_num(gx, 7.0), torch.nan_to_num(want, 7.0))
    assert torch.equal(bmp.bits, want_bits) and bmp.bits.shape == (2, 3)


def test_relu_with_bitmap_pads_like_reference():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((10, 200)).astype(np.float32)
    x[:4] = -1.0
    y, bmp = kops.relu_with_bitmap(torch.from_numpy(x), (4, 128))
    ry, rbmp = ref_ops.relu_with_bitmap(jnp.asarray(x), (4, 128))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(bmp.bits.numpy(), np.asarray(rbmp.bits))
    assert (bmp.block, bmp.shape) == (rbmp.block, rbmp.shape)
    # bf16 keeps its dtype; the bits are exact
    xb = torch.from_numpy(x).bfloat16()
    yb, bmpb = kops.relu_with_bitmap(xb, (1, 32))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, torch.clamp_min(xb, 0))
    assert bmpb.bits[:4].all() and not bmpb.bits[4:].all()


# ------------------------------------------------------------- gated GEMM
def _gemm_case(seed, M, K, N, bm, bk, sparsity, dtype=np.float32):
    """x with whole (bm, bk) tiles zeroed at random; w dense."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    gm, gk = -(-M // bm), -(-K // bk)
    dead = rng.random((gm, gk)) < sparsity
    for i, j in zip(*np.nonzero(dead)):
        x[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = 0.0
    w = rng.standard_normal((K, N)).astype(np.float32)
    return x.astype(dtype), w.astype(dtype)


@pytest.mark.parametrize("M,K,N,bm,bk,bn", [
    (128, 256, 128, 64, 128, 128),
    (64, 128, 256, 8, 128, 128),
    (8, 128, 128, 1, 32, 128),
])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95])
def test_gated_gemm_plain_matches_reference_kernel(M, K, N, bm, bk, bn,
                                                   sparsity):
    x, w = _gemm_case(30, M, K, N, bm, bk, sparsity)
    bits = (~(x.reshape(M // bm, bm, K // bk, bk) != 0).any(axis=(1, 3))
            ).astype(np.int32)
    want = ref_sg.sparce_gemm_gated(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bits), block_m=bm,
        block_k=bk, block_n=bn, interpret=True)
    got = sg.sparce_gemm_gated(*_t(x, w, bits), block_m=bm, block_k=bk,
                               block_n=bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    oracle = kref.sparce_gemm_ref(*_t(x, w), bits_lhs=torch.from_numpy(bits),
                                  block_m=bm, block_k=bk, block_n=bn)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **GEMM_TOL)


@pytest.mark.parametrize("gate", ["lhs", "rhs"])
def test_gated_gemm_dishonest_bits_match_reference(gate):
    """Bits set on nonzero tiles: the product follows the bits, not the
    values (the masked oracle, not the dense product)."""
    M, K, N, bm, bk, bn = 32, 128, 128, 8, 32, 64
    x, w = _gemm_case(31, M, K, N, bm, bk, 0.0)
    shape = (M // bm, K // bk) if gate == "lhs" else (K // bk, N // bn)
    bits = np.zeros(shape, np.int32)
    bits[0, 1] = bits[1, 0] = 1
    want = ref_sg.sparce_gemm_gated(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bits), gate=gate,
        block_m=bm, block_k=bk, block_n=bn, interpret=True)
    got = sg.sparce_gemm_gated(*_t(x, w, bits), gate=gate, block_m=bm,
                               block_k=bk, block_n=bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    assert np.abs(got.numpy() - x @ w).max() > 1e-3  # gating took effect


def test_gated_gemm_bf16_matches_reference_kernel():
    M, K, N, bm, bk, bn = 16, 256, 128, 1, 128, 128
    x, w = _gemm_case(32, M, K, N, bm, bk, 0.5)
    x16 = jnp.asarray(x, jnp.bfloat16)
    w16 = jnp.asarray(w, jnp.bfloat16)
    bits = (~(x.reshape(M, 1, K // bk, bk) != 0).any(axis=(1, 3))
            ).astype(np.int32)
    want = ref_sg.sparce_gemm_gated(x16, w16, jnp.asarray(bits), block_m=bm,
                                    block_k=bk, block_n=bn, interpret=True)
    got = sg.sparce_gemm_gated(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(bits), block_m=bm, block_k=bk, block_n=bn)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("gate", ["lhs", "rhs"])
def test_sparce_gemm_wrapper_ragged_dims_match_reference(gate):
    """Ragged M, K and N: the port pads only the bit grid (padding tiles
    vote 1), the reference pads the operands too; same values."""
    M, K, N = 20, 300, 200
    bm, bk, bn = 8, 128, 128
    x, w = _gemm_case(33, M, K, N, bm, bk, 0.4)
    plan = SkipPlan(gate=gate, variant="gated", block_m=bm, block_k=bk,
                    block_n=bn)
    ref_plan = RefSkipPlan(gate=gate, variant="gated", block_m=bm,
                           block_k=bk, block_n=bn)
    rng = np.random.default_rng(34)
    if gate == "lhs":
        bits = (rng.random((3, 2)) < 0.4).astype(np.int32)  # short of 3x3
        kw = dict(lhs_bitmap=TileBitmap(torch.from_numpy(bits), (bm, bk),
                                        (M, K)))
        rkw = dict(lhs_bitmap=RefTileBitmap(jnp.asarray(bits), (bm, bk),
                                            (M, K)))
    else:
        bits = (rng.random((2, 2)) < 0.4).astype(np.int32)  # short of 3x2
        kw = dict(rhs_bitmap=TileBitmap(torch.from_numpy(bits), (bk, bn),
                                        (K, N)))
        rkw = dict(rhs_bitmap=RefTileBitmap(jnp.asarray(bits), (bk, bn),
                                            (K, N)))
    got = kops.sparce_gemm(*_t(x, w), plan, **kw)
    want = ref_ops.sparce_gemm(jnp.asarray(x), jnp.asarray(w), ref_plan,
                               **rkw)
    assert tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    dense = kops.sparce_gemm(*_t(x, w), SkipPlan(
        gate="none", variant="dense", block_m=bm, block_k=bk, block_n=bn))
    np.testing.assert_allclose(dense.numpy(), x @ w, rtol=1e-4, atol=1e-4)


def test_gated_gemm_nan_poisoned_gated_tiles_never_read():
    """Gated x tiles, and the w k-stripes gated in every row tile, are
    NaN: y is bit-identical. Poisoning an ungated tile does reach y."""
    M, K, N, bm, bk, bn = 8, 128, 96, 1, 32, 128
    x, w = _gemm_case(35, M, K, N, bm, bk, 0.0)
    bits = np.zeros((M, K // bk), np.int32)
    bits[:, 2] = 1  # k-stripe 2 gated in every row
    bits[3] = 1  # row 3 gated across K
    bits[5, 0] = 1
    y = sg.sparce_gemm_gated(*_t(x, w, bits), block_m=bm, block_k=bk,
                             block_n=bn)
    x2, w2 = x.copy(), w.copy()
    for i, j in zip(*np.nonzero(bits)):
        x2[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = np.nan
    w2[2 * bk:3 * bk] = np.nan
    y2 = sg.sparce_gemm_gated(*_t(x2, w2, bits), block_m=bm, block_k=bk,
                              block_n=bn)
    assert torch.isfinite(y2).all() and torch.equal(y2, y)
    assert (y[3] == 0).all()
    x3 = x.copy()
    x3[5, bk] = np.nan  # tile (5, 1) is live
    y3 = sg.sparce_gemm_gated(*_t(x3, w, bits), block_m=bm, block_k=bk,
                              block_n=bn)
    assert torch.isnan(y3[5]).all() and torch.isfinite(y3[:5]).all()
    # rhs: gated w tiles are never read either
    rbits = np.zeros((K // bk, 1), np.int32)
    rbits[1, 0] = 1
    yr = sg.sparce_gemm_gated(*_t(x, w, rbits), gate="rhs", block_m=bm,
                              block_k=bk, block_n=bn)
    w4 = w.copy()
    w4[bk:2 * bk] = np.nan
    yr2 = sg.sparce_gemm_gated(*_t(x, w4, rbits), gate="rhs", block_m=bm,
                               block_k=bk, block_n=bn)
    assert torch.isfinite(yr2).all() and torch.equal(yr2, yr)


def test_gated_gemm_rejects_bad_arguments():
    x, w = _t(*_gemm_case(36, 8, 64, 32, 1, 32, 0.0))
    with pytest.raises(ValueError, match="gate"):
        sg.sparce_gemm_gated(x, w, torch.zeros((8, 2), dtype=torch.int32),
                             block_m=1, block_k=32, block_n=32, gate="both")
    with pytest.raises(ValueError, match="bits must be"):
        sg.sparce_gemm_gated(x, w, torch.zeros((8, 3), dtype=torch.int32),
                             block_m=1, block_k=32, block_n=32)
    with pytest.raises(ValueError, match="shape mismatch"):
        sg.sparce_gemm_gated(x, w.T, torch.zeros((8, 2), dtype=torch.int32),
                             block_m=1, block_k=32, block_n=32)


# -------------------------------------------------------------- fused MLP
def _mlp_case(seed, M, K, F, N, bm, sparsity, dtype=np.float32):
    """Nonnegative x with whole zero row tiles (dead in every stripe),
    positive-biased w_in, signed w_out."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((M, K))).astype(np.float32)
    dead = rng.random(M // bm) < sparsity
    if sparsity >= 1.0:
        dead[:] = True
    for i in np.nonzero(dead)[0]:
        x[i * bm:(i + 1) * bm] = 0.0
    w_in = (np.abs(rng.standard_normal((K, F))) * 0.1).astype(np.float32)
    w_in[:, : F // 4] -= 0.2  # some negative pre-activations
    w_out = (rng.standard_normal((F, N)) * 0.1).astype(np.float32)
    return [a.astype(dtype) for a in (x, w_in, w_out)]


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_fused_mlp_plain_matches_reference_kernel(sparsity, act):
    M, K, F, N, bm, bf = 64, 128, 256, 128, 16, 128
    x, wi, wo = _mlp_case(40, M, K, F, N, bm, sparsity)
    y_ref, bits_ref = ref_sm.sparce_mlp_fused(
        *map(jnp.asarray, (x, wi, wo)), block_m=bm, block_f=bf, act=act,
        interpret=True)
    y, bits = sm.sparce_mlp_fused(*_t(x, wi, wo), block_m=bm, block_f=bf,
                                  act=act)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_ref))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **GEMM_TOL)
    if sparsity == 1.0:
        assert bits.numpy().all() and (y == 0).all()


def test_fused_mlp_bf16_matches_reference_kernel():
    M, K, F, N, bm, bf = 32, 128, 256, 128, 1, 128
    x, wi, wo = _mlp_case(41, M, K, F, N, bm, 0.5)
    j16 = [jnp.asarray(a, jnp.bfloat16) for a in (x, wi, wo)]
    t16 = [t.bfloat16() for t in _t(x, wi, wo)]
    for act in ("relu", "relu2"):
        y_ref, bits_ref = ref_sm.sparce_mlp_fused(
            *j16, block_m=bm, block_f=bf, act=act, interpret=True)
        y, bits = sm.sparce_mlp_fused(*t16, block_m=bm, block_f=bf, act=act)
        assert y.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_ref))
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(y_ref, np.float32), **BF16_TOL)


def test_fused_mlp_odd_patterns():
    """All-zero row tile, fully dense, a single nonzero element."""
    M, K, F, N, bm, bf = 48, 64, 256, 64, 16, 128
    _, wi, wo = _mlp_case(42, M, K, F, N, bm, 0.0)
    wi = np.abs(wi)
    rng = np.random.default_rng(43)
    xs = {
        "dead-middle": np.abs(rng.standard_normal((M, K))).astype(np.float32),
        "dense": np.abs(rng.standard_normal((M, K))).astype(np.float32) + .1,
        "single": np.zeros((M, K), np.float32),
    }
    xs["dead-middle"][16:32] = 0.0
    xs["single"][3, 5] = 2.0
    for name, x in xs.items():
        y_ref, bits_ref = ref_sm.sparce_mlp_fused(
            *map(jnp.asarray, (x, wi, wo)), block_m=bm, block_f=bf,
            interpret=True)
        y, bits = sm.sparce_mlp_fused(*_t(x, wi, wo), block_m=bm, block_f=bf)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_ref),
                                      err_msg=name)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **GEMM_TOL)
    assert int(bits.sum()) == bits.numel() - bits.shape[1]  # "single"


def test_fused_mlp_wrapper_ragged_dims_match_reference():
    """The wrapper takes ragged M and F; nothing past them leaks into y or
    bits."""
    M, K, F, N, bm, bf = 40, 64, 200, 64, 16, 128
    x, wi, wo = _mlp_case(44, M, K, F, N, 8, 0.3)
    y_ref, bmp_ref = ref_ops.sparce_mlp_fused(
        *map(jnp.asarray, (x, wi, wo)), block_m=bm, block_f=bf,
        interpret=True)
    y, bmp = kops.sparce_mlp_fused(*_t(x, wi, wo), block_m=bm, block_f=bf)
    assert tuple(y.shape) == (M, N) and bmp.shape == (M, F)
    np.testing.assert_array_equal(bmp.bits.numpy(), np.asarray(bmp_ref.bits))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **GEMM_TOL)


@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_fused_mlp_nan_poisoned_dead_stripes_never_read(act):
    """w_out rows of stripes dead in every row tile are NaN: y and bits
    are bit-identical. Poisoning a live stripe does reach y."""
    M, K, F, N, bm, bf = 8, 64, 128, 64, 1, 32
    x, wi, wo = _mlp_case(45, M, K, F, N, bm, 0.0)
    wi[:, bf:2 * bf] = -1.0  # stripe 1 dead: negative pre-activation
    x[6] = 0.0  # row 6 dead in every stripe
    y, bits = sm.sparce_mlp_fused(*_t(x, wi, wo), block_m=bm, block_f=bf,
                                  act=act)
    assert bits[:, 1].all() and bits[6].all() and not bits.all()
    wo2 = wo.copy()
    wo2[bf:2 * bf] = np.nan
    y2, bits2 = sm.sparce_mlp_fused(*_t(x, wi, wo2), block_m=bm, block_f=bf,
                                    act=act)
    assert torch.isfinite(y2).all()
    assert torch.equal(y2, y) and torch.equal(bits2, bits)
    assert (y[6] == 0).all()
    assert bits[0, 2] == 0
    wo3 = wo.copy()
    wo3[2 * bf, 0] = np.nan  # stripe 2 is live in row 0
    y3, _ = sm.sparce_mlp_fused(*_t(x, wi, wo3), block_m=bm, block_f=bf,
                                act=act)
    assert torch.isnan(y3[0, 0]) and torch.isfinite(y3[6]).all()


@pytest.mark.parametrize("act", ["relu", "relu2"])
@pytest.mark.parametrize("M,F,bm,bf", [
    (8, 320, 64, 128),   # decode rows under a 64-row tile; ragged F
    (37, 200, 16, 128),  # ragged M and F
    (37, 1000, 1, 128),  # per-row tiles, ragged F
])
def test_fused_mlp_plain_at_ragged_dims_matches_reference(act, M, F, bm,
                                                          bf):
    """The plain version takes M and F that are not block multiples: its
    bits equal the padded reference wrapper's (interpret mode) and y is
    within the f32 tolerance; the zero rows are dead in every stripe and
    the negative stripe in every row tile."""
    rng = np.random.default_rng(46)
    x = np.abs(rng.standard_normal((M, 64))).astype(np.float32)
    x[[1, 5]] = 0.0
    wi = (rng.standard_normal((64, F)) * 0.1).astype(np.float32)
    wi[:, bf:2 * bf] = -np.abs(wi[:, bf:2 * bf])  # stripe 1 dead
    wo = (rng.standard_normal((F, 48)) * 0.1).astype(np.float32)
    y_ref, bmp_ref = ref_ops.sparce_mlp_fused(
        *map(jnp.asarray, (x, wi, wo)), block_m=bm, block_f=bf, act=act,
        interpret=True)
    y, bits = sm.sparce_mlp_fused(*_t(x, wi, wo), block_m=bm, block_f=bf,
                                  act=act)
    assert tuple(bits.shape) == sm.bit_grid(M, F, block_m=bm, block_f=bf)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bmp_ref.bits))
    assert bits.numpy()[:, 1].all() and not bits.numpy().all()
    if bm == 1:
        assert bits.numpy()[[1, 5]].all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **GEMM_TOL)


def test_mlp_ops_wrapper_hands_the_kernel_unpadded_operands(monkeypatch):
    """ops.sparce_mlp_fused pads nothing: the kernel entry gets x and the
    weights at their own shapes (8 decode rows under 64-row tiles, a
    ragged F), and y and the bitmap come back as the entry made them."""
    x, wi, wo = _t(*_mlp_case(47, 8, 64, 200, 48, 1, 0.0))
    seen = []

    def entry(*args, **kw):
        seen.append([tuple(a.shape) for a in args])
        return sm.sparce_mlp_fused_plain(*args, **kw)

    monkeypatch.setattr(sm, "sparce_mlp_fused", entry)
    y, bmp = kops.sparce_mlp_fused(x, wi, wo, block_m=64, block_f=128)
    assert seen == [[(8, 64), (64, 200), (200, 48)]]
    assert tuple(y.shape) == (8, 48) and tuple(bmp.bits.shape) == (1, 2)
    assert bmp.shape == (8, 200) and bmp.block == (64, 128)
    want, want_bits = sm.sparce_mlp_fused_plain(x, wi, wo, block_m=64,
                                                block_f=128)
    assert torch.equal(y, want) and torch.equal(bmp.bits, want_bits)


def test_fused_mlp_ragged_plain_never_reads_dead_stripes_or_past_the_ends():
    """The operands are views of larger buffers holding NaN past M (x's
    rows), past F (w_in's columns, w_out's rows) and in the w_out rows of
    the stripe dead in every row tile: y and the bits equal the clean
    run's, so none of it was read."""
    M, K, F, N, bm, bf = 10, 64, 200, 48, 4, 64
    x, wi, wo = _mlp_case(48, M, K, F, N, 1, 0.0)
    wi[:, bf:2 * bf] = -1.0  # stripe 1 dead in every row tile
    y, bits = sm.sparce_mlp_fused(*_t(x, wi, wo), block_m=bm, block_f=bf)
    assert bits.numpy()[:, 1].all() and not bits.numpy().all()

    def poisoned(a, rows, cols):
        buf = np.full((rows, cols), np.nan, np.float32)
        buf[:a.shape[0], :a.shape[1]] = a
        return torch.from_numpy(buf)

    wo2 = wo.copy()
    wo2[bf:2 * bf] = np.nan
    xp = poisoned(x, M + 6, K)[:M]
    wip = poisoned(wi, K, F + 56)[:, :F]
    wop = poisoned(wo2, F + 56, N)[:F]
    y2, bits2 = sm.sparce_mlp_fused(xp, wip, wop, block_m=bm, block_f=bf)
    assert torch.isfinite(y2).all()
    assert torch.equal(y2, y) and torch.equal(bits2, bits)


@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_fused_mlp_per_row_poison_never_reaches_a_dead_row(act):
    """At block_m 1, NaN in the w_out rows of a stripe live for some rows
    and dead for another: the dead row's output stays finite and equal
    to the clean run's, and a live row takes the poison."""
    M, K, F, N, bm, bf = 8, 64, 128, 32, 1, 32
    x, wi, wo = _mlp_case(49, M, K, F, N, bm, 0.0)
    x[3] = 0.0  # row 3 dead in every stripe
    y, bits = sm.sparce_mlp_fused(*_t(x, wi, wo), block_m=bm, block_f=bf,
                                  act=act)
    assert bits[3].all() and not bits[:, 3].all()
    wo2 = wo.copy()
    wo2[3 * bf:4 * bf] = np.nan
    y2, bits2 = sm.sparce_mlp_fused(*_t(x, wi, wo2), block_m=bm,
                                    block_f=bf, act=act)
    assert torch.equal(bits2, bits)
    assert torch.isfinite(y2[3]).all() and torch.equal(y2[3], y[3])
    live = (bits[:, 3] == 0).nonzero().flatten()
    assert torch.isnan(y2[live]).all()


@pytest.mark.parametrize("m,fdim,n,bf", [(8, 1536, 576, 128),
                                         (37, 1000, 70, 128)])
def test_mlp_scratch_is_a_function_of_the_shapes(m, fdim, n, bf):
    """The fused MLP's f32 scratch is one unpadded (M, N) partial per
    stripe, whatever block_m is, and its bit grid ceil(M/block_m) x
    ceil(F/block_f) is the plain version's."""
    nf = -(-fdim // bf)
    x, wi, wo = _t(*_mlp_case(50, m, 32, fdim, n, 1, 0.0))
    for bm in (1, 16, 64, 256):
        assert sm.partial_shape(m, fdim, n, block_f=bf) == (nf, m, n)
        _, bits = sm.sparce_mlp_fused(x, wi, wo, block_m=bm, block_f=bf)
        assert tuple(bits.shape) == sm.bit_grid(m, fdim, block_m=bm,
                                                block_f=bf) == (-(-m // bm),
                                                                nf)
