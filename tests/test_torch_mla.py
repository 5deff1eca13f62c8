"""DeepSeek-V3's MLA in the port against the reference, on the CPU.

The paged MLA decode kernel's plain version against the reference's
Pallas kernel (interpret mode) and its gathered-view oracle, with its
skip contract; ``mla_forward`` prefill and absorbed decode (gather and
paged) against the reference's; the DeepSeek config and its parameter
count; and the two repairs the full-width model needed: slab-wise
initialisation and the f32 head product taken in vocab slices. Inputs
come from numpy seeds and go to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import paged_decode_attn as ref_pda
from repro.kernels import ref as ref_kref
from repro.models import attention as ref_attn
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_decode_attn as pda
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as attn
from repro_torch.models import model as model_lib
from repro_torch.models import modules

ARCH = "deepseek-v3-671b"
BS = 4  # pool rows per block in the kernel tests
SCALE = (16 + 8) ** -0.5  # the reduced config's (nope + rope) ** -0.5
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order
# bf16 inputs; the kernels round p to bf16 against a running max, the
# oracle never rounds p; bf16 output rounding of values ~1.
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
ATOL = 1e-4  # mla_forward outputs at f32: several products in sequence


def _mla_case(seed, lengths, *, max_blocks=6, h=4, r=16, rope=8):
    """f32 arrays: queries, latent pools, tables whose entries past each
    live prefix name blocks no slot uses (they get poisoned below)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    live = [min(-(-int(n) // BS), max_blocks) for n in lengths]
    nb = sum(live) + 1 + 4
    ids = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, max_blocks), np.int32)
    nxt = 0
    for b in range(B):
        tables[b, :live[b]] = ids[nxt:nxt + live[b]]
        nxt += live[b]
    spare = ids[nxt:]
    for b in range(B):
        tables[b, live[b]:] = rng.choice(spare, max_blocks - live[b])
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q_lat=mk(B, h, r), q_rope=mk(B, h, rope), ckv=mk(nb, BS, r),
                kr=mk(nb, BS, rope), tables=tables,
                lengths=np.asarray(lengths, np.int32),
                live_ids=set(ids[:nxt].tolist()), nb=nb)


_ORDER = ("q_lat", "q_rope", "ckv", "kr", "tables", "lengths")


def _torch_args(c, dtype=torch.float32):
    out = []
    for k in _ORDER:
        t = torch.from_numpy(np.ascontiguousarray(c[k]))
        out.append(t.to(dtype) if t.is_floating_point() else t)
    return out


def _jax_args(c, dtype=jnp.float32):
    return [jnp.asarray(c[k], dtype) if c[k].dtype == np.float32
            else jnp.asarray(c[k]) for k in _ORDER]


# -------------------------------------------------------- the MLA kernel
@pytest.mark.parametrize("lengths", [
    [1, 9, 24, 13],  # ragged, mid-block
    [8, 16, 4, 12],  # exact block edges
    [24, 0, 7, 0],   # dead slots interleaved
])
def test_mla_plain_matches_reference_kernel_f32(lengths):
    c = _mla_case(0, lengths)
    want = np.asarray(ref_pda.paged_mla_decode_attn(
        *_jax_args(c), scale=SCALE, interpret=True))
    got = pda.paged_mla_decode_attn(*_torch_args(c), scale=SCALE).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    live = c["lengths"] > 0
    oracle = np.asarray(ref_kref.paged_mla_decode_attn_ref(
        *_jax_args(c), scale=SCALE))
    np.testing.assert_allclose(got[live], oracle[live], **F32_TOL)
    port_oracle = kref.paged_mla_decode_attn_ref(*_torch_args(c),
                                                 scale=SCALE).numpy()
    np.testing.assert_allclose(port_oracle[live], oracle[live], **F32_TOL)
    assert np.all(got[~live] == 0.0)  # nothing read, zeros written


@pytest.mark.parametrize("lengths", [[0, 4, 17, 24], [3, 0, 12, 1]])
def test_mla_plain_matches_reference_kernel_bf16(lengths):
    c = _mla_case(1, lengths)
    want = np.asarray(ref_pda.paged_mla_decode_attn(
        *_jax_args(c, jnp.bfloat16), scale=SCALE, interpret=True),
        np.float32)
    got = pda.paged_mla_decode_attn(*_torch_args(c, torch.bfloat16),
                                    scale=SCALE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    live = c["lengths"] > 0
    oracle = np.asarray(ref_kref.paged_mla_decode_attn_ref(
        *_jax_args(c, jnp.bfloat16), scale=SCALE), np.float32)
    np.testing.assert_allclose(got.float().numpy()[live], oracle[live],
                               **BF16_TOL)
    assert np.all(got.float().numpy()[~live] == 0.0)


def test_mla_wrapper_clamps_lengths_past_the_table():
    """A length past max_blocks * bs clamps to the table's reach, as the
    reference wrapper does; the raw plain version caps its loop at the
    table width and gives the same result."""
    c = _mla_case(2, [24, 5, 0])
    over = c["lengths"].copy()
    over[0] = 1000
    want = np.asarray(ref_ops.paged_mla_decode_attn(
        *_jax_args(c)[:5], jnp.asarray(over), scale=SCALE))
    args = _torch_args(c)
    got = kops.paged_mla_decode_attn(*args[:5], torch.from_numpy(over),
                                     scale=SCALE)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    raw = pda.paged_mla_decode_attn(*args[:5], torch.from_numpy(over),
                                    scale=SCALE)
    assert torch.equal(raw, pda.paged_mla_decode_attn(*args, scale=SCALE))


def _poisoned(c):
    """The case with NaN in the null block and in every block outside
    the live prefixes (which the dead table entries name)."""
    dead = [i for i in range(c["nb"]) if i not in c["live_ids"]]
    p = dict(c, ckv=c["ckv"].copy(), kr=c["kr"].copy())
    p["ckv"][dead] = np.nan
    p["kr"][dead] = np.nan
    return p


def test_mla_nan_poisoned_dead_blocks_never_read():
    c = _mla_case(3, [9, 0, 24, 3])
    base = pda.paged_mla_decode_attn(*_torch_args(c), scale=SCALE)
    poisoned = pda.paged_mla_decode_attn(*_torch_args(_poisoned(c)),
                                         scale=SCALE)
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, base)


def test_mla_nan_poison_catches_a_read_one_block_past(monkeypatch):
    """The poison test has teeth: a mutant that reads one block past
    each slot's live count picks up the poison in every live slot that
    has a block left in its table row."""
    c = _poisoned(_mla_case(4, [9, 0, 13, 3]))
    real = pda.live_block_count

    def one_past(length, block_size, max_blocks):
        n = real(length, block_size, max_blocks)
        return min(n + 1, max_blocks) if n else 0

    monkeypatch.setattr(pda, "live_block_count", one_past)
    out = pda.paged_mla_decode_attn(*_torch_args(c), scale=SCALE)
    nan_slots = torch.isnan(out).flatten(1).any(dim=1).tolist()
    assert nan_slots == [True, False, True, True]


def test_mla_masks_rows_past_length_in_last_block():
    """Rows past the length inside the last live block are multiplied by
    p = 0: huge (finite) values there do not move the output."""
    c = _mla_case(5, [6, 2])
    base = pda.paged_mla_decode_attn(*_torch_args(c), scale=SCALE)
    c2 = dict(c, ckv=c["ckv"].copy(), kr=c["kr"].copy())
    for b, n in enumerate(c["lengths"]):
        last = c["tables"][b, (int(n) - 1) // BS]
        c2["ckv"][last, int(n) % BS:] = 1e9
        c2["kr"][last, int(n) % BS:] = -1e9
    got = pda.paged_mla_decode_attn(*_torch_args(c2), scale=SCALE)
    np.testing.assert_allclose(got.numpy(), base.numpy(), **F32_TOL)


def test_mla_wrapper_takes_plain_version_only_for_cpu_tensors():
    c = _mla_case(6, [3, 0])
    before = pda.paged_mla_decode_attn.launches
    pda.paged_mla_decode_attn(*_torch_args(c), scale=SCALE)
    assert pda.paged_mla_decode_attn.launches == before  # nothing launched
    meta = [t.to("meta") for t in _torch_args(c)]
    with pytest.raises(ValueError, match="unsupported device"):
        pda.paged_mla_decode_attn(*meta, scale=SCALE)


@pytest.mark.parametrize("B,h,r,max_blocks,bs", [
    (8, 128, 512, 32, 16),  # the DeepSeek decode shape
    (5, 12, 16, 6, 4),      # the small ragged shape
    (3, 40, 100, 5, 24),    # heads past a group, blocks past a piece
    (1, 128, 512, 4096, 16),  # one slot, a long table
    (2, 16, 64, 65536, 1),    # a table past a chunk's shared entries
])
def test_mla_scratch_is_a_function_of_the_shapes(B, h, r, max_blocks, bs):
    """The MLA kernel's chunks and f32 scratch follow from the shapes
    alone: S chunks of E entries cover the table, no chunk is empty at
    a full table, a chunk holds 64 rows at least (or the whole table),
    and the scratch is (slots, chunks, heads, latent + 2 rounded up to
    4)."""
    s, e = pda.mla_chunks(B, h, max_blocks, bs)
    assert s * e >= max_blocks > (s - 1) * e
    assert e <= pda.MLA_MAX_CHUNK_ENTRIES
    assert e * bs >= min(pda.MLA_MIN_CHUNK_ROWS, max_blocks * bs)
    assert pda.mla_scratch_shape(B, h, r, max_blocks, bs) == (
        B, s, h, -(-(r + 2) // 4) * 4)
    grid = pda.mla_grid(B, h, max_blocks, bs)
    assert grid["ctas"] == s * -(-h // pda.MLA_HEADS_PER_CTA) * B
    for lengths in ([0] * B, [max_blocks * bs] * B):
        c = dict(tables=np.zeros((B, max_blocks), np.int32),
                 lengths=np.asarray(lengths, np.int32))
        assert pda.mla_chunks(B, h, max_blocks, bs) == (s, e)
        assert len(pda.mla_chunk_walk(c["tables"], c["lengths"], bs,
                                      h)[0]) == s


def test_mla_grid_fills_the_card_at_the_engine_shape():
    """At the DeepSeek decode shape (8 slots, 128 heads, 32 table entries
    of 16 rows) the launch has at least 132 CTAs: 8 chunks of 4 entries
    x 4 head groups x 8 slots."""
    grid = pda.mla_grid(8, 128, 32, 16)
    assert grid == dict(chunks=8, entries=4, head_groups=4, ctas=256)
    assert grid["ctas"] >= 132


@pytest.mark.parametrize("lengths", [
    [64, 65, 512, 513, 0, 63, 128, 1],  # chunk edges, reach, past it
    [1, 17, 300, 0, 0, 511, 16, 33],    # trailing chunks empty
    [0] * 8,                            # nothing live
])
def test_mla_chunk_walk_reads_exactly_the_live_blocks(lengths):
    """Host-side skip contract of the chunked kernel: over its chunks a
    slot reads exactly ``live_block_ids`` in order, no chunk reads more
    than E entries, and a chunk at or past the live count reads none."""
    B, h, max_blocks, bs = 8, 128, 32, 16
    rng = np.random.default_rng(7)
    tables = rng.permutation(np.arange(1, B * max_blocks + 1)).reshape(
        B, max_blocks).astype(np.int32)
    s, e = pda.mla_chunks(B, h, max_blocks, bs)
    walk = pda.mla_chunk_walk(tables, np.asarray(lengths), bs, h)
    live = pda.live_block_ids(tables, np.minimum(lengths, max_blocks * bs),
                              bs)
    for b, n in enumerate(lengths):
        chunks = walk[b]
        assert len(chunks) == s
        np.testing.assert_array_equal(np.concatenate(chunks), live[b])
        nblk = pda.live_block_count(n, bs, max_blocks)
        for ci, got in enumerate(chunks):
            assert len(got) <= e
            if ci * e >= nblk:
                assert len(got) == 0


# ------------------------------------------------------------ mla_forward
def _mla_params(seed=0):
    ref_cfg = ref_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    ref_p = ref_attn.mla_init(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    np_p = jax.tree_util.tree_map(np.asarray, ref_p)
    port_p = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                    np_p)
    return ref_cfg, cfg, ref_p, port_p


def test_mla_forward_prefill_matches_reference():
    """Exact-length prefill into a contiguous cache at per-slot offsets:
    the output and the cached latents and rope keys."""
    ref_cfg, cfg, ref_p, port_p = _mla_params()
    rng = np.random.default_rng(0)
    B, S, L = 2, 7, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    start = np.array([0, 3], np.int32)
    pos = (start[:, None] + np.arange(S)[None]).astype(np.int32)
    ref_c = ref_attn.mla_init_cache(ref_cfg, B, L, jnp.float32)
    ref_c = ref_c._replace(length=jnp.asarray(start))
    y_ref, c_ref = ref_attn.mla_forward(ref_p, jnp.asarray(x),
                                        jnp.asarray(pos), ref_cfg,
                                        cache=ref_c)
    big = attn.mla_init_cache(cfg, B, L, torch.float32, "cpu")
    c = attn.KVCache(big.k[0], big.v[0], torch.from_numpy(start))
    y, c_new = attn.mla_forward(port_p, torch.from_numpy(x),
                                torch.from_numpy(pos), cfg, cache=c)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(c_new.k.numpy(), np.asarray(c_ref.k),
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(c_new.v.numpy(), np.asarray(c_ref.v),
                               rtol=ATOL, atol=ATOL)
    assert c_new.length.tolist() == np.asarray(c_ref.length).tolist()
    # No cache (training-style forward) and the continuation refusal.
    y0, _ = attn.mla_forward(port_p, torch.from_numpy(x),
                             torch.from_numpy(pos), cfg)
    y0_ref, _ = ref_attn.mla_forward(ref_p, jnp.asarray(x), jnp.asarray(pos),
                                     ref_cfg)
    np.testing.assert_allclose(y0.numpy(), np.asarray(y0_ref), rtol=ATOL,
                               atol=ATOL)
    with pytest.raises(NotImplementedError, match="continuation"):
        attn.mla_forward(port_p, torch.from_numpy(x), torch.from_numpy(pos),
                         cfg, cache=c, continuation=True)


@pytest.mark.parametrize("attn_kernel", ["gather", "paged"])
def test_mla_forward_paged_decode_matches_reference(attn_kernel):
    """Absorbed decode over the latent pool, one dead slot: the output of
    the live slots, the appended pool rows and the new lengths."""
    ref_cfg, cfg, ref_p, port_p = _mla_params(1)
    m = cfg.mla
    rng = np.random.default_rng(1)
    B, max_blocks, bs = 4, 4, 8
    lengths = np.array([5, 0, 16, 23], np.int32)
    nb = B * max_blocks + 1
    ckv = rng.standard_normal((nb, bs, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((nb, bs, m.qk_rope_dim)).astype(np.float32)
    tables = np.zeros((B, max_blocks), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    nxt = 0
    for b, n in enumerate(lengths):
        kk = -(-(int(n) + 1) // bs) if n else 0
        tables[b, :kk] = ids[nxt:nxt + kk]
        nxt += kk
    active = (lengths > 0).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    x[~(active > 0)] = 0.0
    pos = lengths[:, None].astype(np.int32)
    ref_cache = ref_attn.PagedKVCache(jnp.asarray(ckv), jnp.asarray(kr),
                                      jnp.asarray(lengths))
    y_ref, c_ref = ref_attn.mla_forward(
        ref_p, jnp.asarray(x), jnp.asarray(pos), ref_cfg, cache=ref_cache,
        block_tables=jnp.asarray(tables), attn_kernel=attn_kernel,
        active=jnp.asarray(active))
    cache = attn.PagedKVCache(torch.from_numpy(ckv.copy()),
                              torch.from_numpy(kr.copy()),
                              torch.from_numpy(lengths))
    y, c_new = attn.mla_forward(
        port_p, torch.from_numpy(x), torch.from_numpy(pos), cfg,
        cache=cache, block_tables=torch.from_numpy(tables),
        attn_kernel=attn_kernel, active=torch.from_numpy(active))
    live = active > 0
    np.testing.assert_allclose(y.numpy()[live], np.asarray(y_ref)[live],
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(c_new.k.numpy(), np.asarray(c_ref.k),
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(c_new.v.numpy(), np.asarray(c_ref.v),
                               rtol=ATOL, atol=ATOL)
    assert c_new.length.tolist() == np.asarray(c_ref.length).tolist()


def test_insert_slot_paged_fills_both_stacks_full_width_pools():
    """Admission scatters a prefilled contiguous cache of both stacks
    (dense_stack and stack) into the 512- and 64-wide latent pools: the
    rows land at the table's blocks in every layer, bucket padding lands
    in the null block, and only the slot's lengths move."""
    full = get_config(ARCH)
    cfg = dataclasses.replace(full.reduced(), mla=full.mla, num_layers=3,
                              first_k_dense=2)
    rng = np.random.default_rng(2)
    bs, max_blocks, S, slot, true_len = 16, 4, 40, 1, 37
    big = model_lib.init_paged_caches(cfg, 3, 9, bs, device="cpu")
    small = model_lib.init_caches(cfg, 1, S, device="cpu")
    assert sorted(big) == sorted(small) == ["dense_stack", "stack"]
    for key in small:
        for t in (small[key].k, small[key].v):
            t.copy_(torch.from_numpy(rng.standard_normal(
                tuple(t.shape)).astype(np.float32)))
    assert tuple(big["stack"].k.shape[2:]) == (bs, 512)
    assert tuple(big["dense_stack"].v.shape) == (2, 9, bs, 64)
    ids = torch.tensor([5, 2, 7, 0])  # 3 blocks; the 4th is padding
    model_lib.insert_slot_paged(big, small, slot, ids, true_len)
    for key, n_layers in (("dense_stack", 2), ("stack", 1)):
        for pool, rows in ((big[key].k, small[key].k),
                           (big[key].v, small[key].v)):
            for p in range(min(S, 3 * bs)):
                blk = int(ids[p // bs])
                torch.testing.assert_close(pool[:, blk, p % bs],
                                           rows[:, 0, p], rtol=0, atol=0)
            assert pool.shape[0] == n_layers
        assert big[key].length[:, slot].tolist() == [true_len] * n_layers
        assert big[key].length[:, 0].tolist() == [0] * n_layers


# --------------------------------------------------------------- config
@pytest.mark.parametrize("reduced", [False, True])
def test_deepseek_config_and_param_counts_equal_reference(reduced):
    ref = ref_get_config(ARCH)
    port = get_config(ARCH)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params()
    assert port.n_params_active() == ref.n_params_active()
    smol = get_config("smollm-135m")
    assert smol.n_params_active() == ref_get_config(
        "smollm-135m").n_params_active()


# ------------------------------------------------------ full-width repairs
def test_slab_wise_init_leaves_smollm_weights_unchanged(monkeypatch):
    """Drawing each leaf in leading-dim slabs gives the numbers of one
    whole-leaf draw: smollm-135m's full-width leaves are unchanged."""
    cfg = get_config("smollm-135m")
    whole = model_lib.init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(modules, "SLAB_VALUES", 1 << 14)  # every leaf slabs
    slabbed = model_lib.init_params(cfg, seed=0, device="cpu")
    a, b = list(modules.iter_leaves(whole)), list(
        modules.iter_leaves(slabbed))
    assert len(a) == len(b) == 2 + 9 * cfg.num_layers
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_head_product_in_vocab_slices_leaves_logits_unchanged(monkeypatch):
    """The f32 logits of a bf16 head taken slice by slice equal the
    product with the whole head upcast."""
    for name in ("smollm-135m", ARCH):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="bfloat16")
        params = model_lib.init_params(cfg, seed=1, device="cpu")
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (2, 3, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["head"])
        want = x.float() @ head.float()
        monkeypatch.setattr(model_lib, "HEAD_SLICE_VALUES",
                            cfg.d_model * 48)  # 48 columns per slice
        got = model_lib._logits(params, cfg, x)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)
