"""The port's prefix cache against the reference's single-host engine.

Same reduced smollm config (f32), same weights (carried over by the
bridge), same shared-prefix traffic (built by ``test_prefix_cache.py``'s
``_shared_traffic``): with ``ServeConfig(prefix_cache=True)`` the port's
drain-mode ``Server.generate`` must reproduce the reference's tokens,
admission order, every integer and modeled metric and every prefix-cache
counter; turning the cache on must change no token and no decode-phase
skip counter; the pool must drain to the blocks only the index holds.
The pool operations the path adds are held against the reference's
functions one by one. The reference runs its Pallas kernels in
interpret mode, as its own tests do.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.sparse_ops import SparsityConfig as RefSparsityConfig
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro.runtime import server as ref_server
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.models import attention as port_attn
from repro_torch.models import model as port_model
from repro_torch.runtime import server as port_server
from test_prefix_cache import _shared_traffic
from test_torch_server import EXACT_FIELDS

PREFIX_FIELDS = (
    "prefix_cache_enabled", "prefix_lookups", "prefix_hits",
    "prefix_hit_rate", "prefix_matched_tokens", "prefix_blocks_shared",
    "prefix_cow_forks", "prefix_evicted_blocks", "prefix_cache_blocks",
    "prefill_ticks_nocache", "prefill_ticks_saved",
    "prefill_ticks_saved_frac", "prefill_flops_saved",
)
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order


def _configs(act=None):
    ref_cfg = ref_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    if act is not None:
        ref_cfg = dataclasses.replace(ref_cfg, mlp_act=act)
        cfg = dataclasses.replace(cfg, mlp_act=act)
    return ref_cfg, cfg


def _params(ref_cfg, seed=0):
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")


def _port_reqs(reqs):
    return [port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                                max_new=r.max_new, eos_id=r.eos_id)
            for r in reqs]


def _serve_both(reqs, *, act=None, sp=None, **sc_kw):
    """The reference engine and the port's on the same requests, weights
    and ServeConfig fields. Returns (ref_srv, ref_done, srv, done)."""
    ref_cfg, cfg = _configs(act)
    ref_params, params = _params(ref_cfg)
    kw = dict(max_len=64, kv_block_size=8, **sc_kw)
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_server.ServeConfig(
        sparsity=None if sp is None else RefSparsityConfig(**sp), **kw))
    ref_done = ref_srv.generate(
        [dataclasses.replace(r, out=None, stats={}) for r in reqs])
    srv = port_server.Server(cfg, params, port_server.ServeConfig(
        sparsity=None if sp is None else SparsityConfig(**sp), **kw),
        device="cpu")
    return ref_srv, ref_done, srv, srv.generate(_port_reqs(reqs))


def _assert_same_as_reference(ref_srv, ref_done, srv, done):
    """Tokens, completion and admission order, every exact metric and
    prefix counter; the pool drains to the blocks the index holds."""
    want = {r.uid: np.asarray(r.out) for r in ref_done}
    got = {r.uid: np.asarray(r.out) for r in done}
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid={uid}")
    assert [r.uid for r in done] == [r.uid for r in ref_done]
    assert list(srv.admitted_uids) == list(ref_srv.admitted_uids)
    for name in EXACT_FIELDS + PREFIX_FIELDS:
        assert getattr(srv.metrics, name) == getattr(ref_srv.metrics,
                                                     name), name
    st = srv._st
    assert all(s is None for s in st.slots)
    assert st.alloc.reserved == 0
    assert st.alloc.in_use == len(srv._prefix) == len(ref_srv._prefix)
    st.alloc.check(expect_reserved=0)


@pytest.mark.parametrize("case", [
    # The GLU fused path (plain version of the fused GLU kernel) over the
    # paged decode kernel's plain version, buckets the default powers of 2.
    dict(act=None, attn_kernel="paged",
         sp=dict(enabled=True, mode="fused", gate_threshold=0.0,
                 autotune=False)),
    # The relu MLP under the reference mode, explicit buckets, 3 slots.
    dict(act="relu", attn_kernel="gather", prefill_buckets=(4, 8, 16, 32),
         sp=dict(enabled=True, mode="reference", block_m=1, block_k=128)),
], ids=["glu-fused-paged", "relu-reference-buckets"])
def test_prefix_engine_matches_reference_engine(case):
    case = dict(case)
    ref_cfg, _ = _configs(case.get("act"))
    reqs = _shared_traffic(ref_cfg, n_prefixes=2, prefix_len=16,
                           n_requests=6, seed=3)
    out = _serve_both(reqs, batch_slots=3, prefix_cache=True, **case)
    _assert_same_as_reference(*out)
    m = out[2].metrics
    assert m.prefix_lookups == 6 and m.prefix_hits == 4
    assert m.prefix_matched_tokens == 4 * 16 and m.prefix_blocks_shared == 8
    assert m.prefill_flops_saved > 0  # ticks: weight-read bound, equal


@pytest.mark.parametrize("sp,act", [
    (dict(enabled=True, mode="reference", block_m=1, block_k=128), "relu"),
    (dict(enabled=True, mode="fused", gate_threshold=0.0, autotune=False),
     None),
], ids=["relu-reference", "glu-fused"])
def test_cache_off_and_on_serve_the_same_tokens(sp, act):
    """The port alone, cache off then on: equal tokens, decode tokens and
    decode-phase skip counters (the prefill slice legitimately shrinks:
    that is the saving)."""
    ref_cfg, cfg = _configs(act)
    _, params = _params(ref_cfg)
    reqs = _shared_traffic(ref_cfg, n_prefixes=2, prefix_len=16,
                           n_requests=6, seed=3)
    runs = {}
    for on in (False, True):
        srv = port_server.Server(cfg, params, port_server.ServeConfig(
            batch_slots=3, max_len=64, kv_block_size=8, prefix_cache=on,
            attn_kernel="paged", sparsity=SparsityConfig(**sp)),
            device="cpu")
        done = srv.generate(_port_reqs(reqs))
        runs[on] = ({r.uid: r.out.tolist() for r in done}, srv.metrics)
    (out_off, m_off), (out_on, m_on) = runs[False], runs[True]
    assert out_on == out_off
    for total, pre in (("skipped_tile_dots", "prefill_skipped_tile_dots"),
                       ("total_tile_dots", "prefill_total_tile_dots")):
        assert (getattr(m_on, total) - getattr(m_on, pre)
                == getattr(m_off, total) - getattr(m_off, pre))
    for name in ("decode_tokens", "ticks", "attn_blocks_fetched",
                 "attn_blocks_total"):
        assert getattr(m_on, name) == getattr(m_off, name), name
    assert m_on.prefill_tokens < m_off.prefill_tokens
    assert m_on.prefix_hits == 4 and m_off.prefix_lookups == 0
    assert (m_on.prefix_cache_enabled, m_off.prefix_cache_enabled) == (1, 0)


def test_cow_fork_on_a_full_prompt_match():
    """A byte-identical re-prompt of whole blocks: the engine forks the
    last block, re-runs only the last token, and equals the reference;
    the index keeps one copy (the fork stays private)."""
    ref_cfg, _ = _configs()
    prompt = np.arange(16) % ref_cfg.vocab_size
    reqs = [ref_server.Request(uid=0, prompt=prompt.copy(), max_new=4),
            ref_server.Request(uid=1, prompt=prompt.copy(), max_new=6)]
    out = _serve_both(reqs, batch_slots=2, prefix_cache=True)
    _assert_same_as_reference(*out)
    srv, done = out[2], out[3]
    got = {r.uid: np.asarray(r.out) for r in done}
    np.testing.assert_array_equal(got[0], got[1][:4])
    m = srv.metrics
    assert (m.prefix_cow_forks, m.prefix_hits, m.prefix_matched_tokens) == (
        1, 1, 15)
    assert len(srv._prefix) == 2


def test_eos_midstream_release_with_sharers():
    """Sharers that end at different times (max_new 1, an EOS mid-stream,
    a full budget) drop their shared references while neighbours still
    read the blocks: tokens equal the reference's, and the pool drains
    to the index-only holders."""
    ref_cfg, _ = _configs()
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, ref_cfg.vocab_size, 16)
    prompts = [np.concatenate([prefix, rng.integers(0, ref_cfg.vocab_size,
                                                    n)]) for n in (3, 5, 2)]
    # The middle sharer's EOS is its own second greedy token.
    probe = _serve_both([ref_server.Request(uid=1, prompt=prompts[1],
                                            max_new=6)],
                        batch_slots=1, prefix_cache=False)
    eos = int(np.asarray(probe[1][0].out)[1])
    reqs = [ref_server.Request(uid=0, prompt=prompts[0], max_new=1),
            ref_server.Request(uid=1, prompt=prompts[1], max_new=6,
                               eos_id=eos),
            ref_server.Request(uid=2, prompt=prompts[2], max_new=6)]
    out = _serve_both(reqs, batch_slots=3, prefix_cache=True)
    _assert_same_as_reference(*out)
    assert {r.uid: len(r.out) for r in out[3]} == {0: 1, 1: 2, 2: 6}
    assert out[2].metrics.prefix_hits == 2


def test_eviction_under_a_small_pool():
    """A pool too small to keep every prefix: admissions evict blocks
    only the index holds (LRU), and the engine still equals the
    reference in tokens, order and every counter."""
    ref_cfg, _ = _configs()
    reqs = _shared_traffic(ref_cfg, n_prefixes=3, prefix_len=16,
                           n_requests=7, tail=(1, 6), max_new=(2, 6),
                           seed=11)
    out = _serve_both(reqs, batch_slots=2, prefix_cache=True,
                      kv_pool_blocks=8)
    _assert_same_as_reference(*out)
    assert out[2].metrics.prefix_evicted_blocks > 0


def _paged_pools(cfg, rng, nb=9, bs=8):
    """Random layer-stacked pools in both frameworks, (2, nb, bs, KV, hd)
    f32, batch 2 lengths."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = rng.standard_normal((cfg.num_layers, nb, bs, kv, hd)).astype(
        np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    length = np.zeros((cfg.num_layers, 2), np.int32)
    ref = {"stack": ref_attn.PagedKVCache(jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(length))}
    port = {"stack": port_attn.PagedKVCache(
        torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
        torch.from_numpy(length.copy()))}
    return ref, port


def _assert_pools_equal(ref, port, skip_null=False):
    for a, b in ((ref["stack"].k, port["stack"].k),
                 (ref["stack"].v, port["stack"].v)):
        a = np.asarray(a)
        b = b.numpy()
        if skip_null:  # redirected writes race for the null block
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(port["stack"].length.numpy(),
                                  np.asarray(ref["stack"].length))


def test_pool_operations_match_reference():
    """``paged_prefix_caches``, ``insert_slot_paged_from`` and
    ``copy_pool_block`` against the reference's on the same pools: the
    gathered prefix and its zero tail, the suffix scatter (shared blocks
    never written, rows below start_row and past the table sent to the
    null block) and the in-place block copy."""
    _, cfg = _configs()
    rng = np.random.default_rng(7)
    ref, port = _paged_pools(cfg, rng)
    table = np.array([3, 5, 2, 0], np.int32)  # 3 live blocks of a slot
    prefix_len, small_len, bs = 13, 40, 8
    want = ref_model.paged_prefix_caches(ref, jnp.asarray(table), prefix_len,
                                         small_len)
    got = port_model.paged_prefix_caches(port, torch.from_numpy(table),
                                         prefix_len, small_len)
    for a, b in ((want["stack"].k, got["stack"].k),
                 (want["stack"].v, got["stack"].v),
                 (want["stack"].length, got["stack"].length)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert not got["stack"].k[:, :, prefix_len:].any()
    # The suffix scatter: rows 13..21 of a 40-row scratch, table of 4.
    small_k = rng.standard_normal(tuple(got["stack"].k.shape)).astype(
        np.float32)
    small_v = rng.standard_normal(small_k.shape).astype(np.float32)
    small_len_arr = np.full((cfg.num_layers, 1), 22, np.int32)
    ref_small = {"stack": ref_attn.KVCache(
        jnp.asarray(small_k), jnp.asarray(small_v),
        jnp.asarray(small_len_arr))}
    port_small = {"stack": port_attn.KVCache(
        torch.from_numpy(small_k), torch.from_numpy(small_v),
        torch.from_numpy(small_len_arr))}
    shared_before = port["stack"].k[:, [3]].clone()  # rows 0..7: shared
    ref = ref_model.insert_slot_paged_from(
        ref, ref_small, jnp.int32(1), jnp.asarray(table), jnp.int32(22),
        jnp.int32(prefix_len))
    port = port_model.insert_slot_paged_from(
        port, port_small, 1, torch.from_numpy(table), 22, prefix_len)
    _assert_pools_equal(ref, port, skip_null=True)
    assert torch.equal(port["stack"].k[:, [3]], shared_before)
    ref = ref_model.copy_pool_block(ref, jnp.int32(7), jnp.int32(5))
    port = port_model.copy_pool_block(port, 7, 5)
    _assert_pools_equal(ref, port, skip_null=True)
    assert torch.equal(port["stack"].v[:, 7], port["stack"].v[:, 5])


def test_continuation_prefill_matches_reference():
    """``gqa_forward(continuation=True)`` behind a gathered 11-row prefix,
    a 5-token suffix padded to 8 (advance 5), over a 32-row scratch:
    outputs and cache rows equal the reference's; the real rows equal a
    full prefill's last 5 rows; the cache length advances by 5."""
    ref_cfg, cfg = _configs()
    ref_params, params = _params(ref_cfg)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, 16)
    prefix_len, n_suffix, S_pad, L = 11, 5, 8, 32
    # The prefix rows come from a full prefill of the first 11 tokens.
    full_cache = port_model.init_caches(cfg, 1, L, device="cpu")
    with torch.no_grad():
        _, full_cache, _ = port_model.forward(
            params, cfg, {"tokens": torch.from_numpy(toks[None, :prefix_len])},
            full_cache)
    lp = params["stack"][0]["attn"]
    ref_lp = jax.tree_util.tree_map(lambda a: a[0],
                                    ref_params["stack"])["attn"]
    x = rng.standard_normal((1, S_pad, cfg.d_model)).astype(np.float32)
    pos = (prefix_len + np.arange(S_pad, dtype=np.int32))[None]
    k0 = full_cache["stack"].k[0].numpy()
    v0 = full_cache["stack"].v[0].numpy()
    ln = np.array([prefix_len], np.int32)
    adv = np.array([n_suffix], np.int32)
    want_y, want_c = ref_attn.gqa_forward(
        ref_lp, jnp.asarray(x), jnp.asarray(pos), ref_cfg,
        cache=ref_attn.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                               jnp.asarray(ln)),
        advance=jnp.asarray(adv), continuation=True)
    with torch.no_grad():
        y, c = port_attn.gqa_forward(
            lp, torch.from_numpy(x), torch.from_numpy(pos), cfg,
            cache=port_attn.KVCache(torch.from_numpy(k0.copy()),
                                    torch.from_numpy(v0.copy()),
                                    torch.from_numpy(ln)),
            advance=torch.from_numpy(adv), continuation=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32_TOL)
    np.testing.assert_allclose(c.k.numpy(), np.asarray(want_c.k), **F32_TOL)
    assert int(c.length[0]) == prefix_len + n_suffix
    with pytest.raises(ValueError, match="batch=1"):
        port_attn.gqa_forward(
            lp, torch.zeros((2, 4, cfg.d_model)),
            torch.zeros((2, 4), dtype=torch.int32), cfg,
            cache=port_model.init_caches(cfg, 2, 8, device="cpu")[
                "stack"]._replace(k=torch.zeros((2, 8, 2, 16)),
                                  v=torch.zeros((2, 8, 2, 16)),
                                  length=torch.zeros(2, dtype=torch.int32)),
            continuation=True)


def test_shared_blocks_are_not_written_by_a_hit():
    """Around every suffix prefill of a run with hits: the bytes of the
    blocks mapped read-only into the table (the whole blocks below the
    prefix length) are the same after the prefill and its scatter as
    before, in every layer of k and v."""
    ref_cfg, cfg = _configs()
    _, params = _params(ref_cfg)
    reqs = _port_reqs(_shared_traffic(ref_cfg, n_prefixes=2, prefix_len=16,
                                      n_requests=6, seed=3))
    srv = port_server.Server(cfg, params, port_server.ServeConfig(
        batch_slots=3, max_len=64, kv_block_size=8, prefix_cache=True,
        attn_kernel="paged"), device="cpu")
    real, checked = srv._prefill_suffix, []

    def watched(r, slot, caches, table_row, prefix_len, rows0):
        shared = [int(b) for b in table_row[:prefix_len // 8]]
        before = [(c.k[:, shared].clone(), c.v[:, shared].clone())
                  for c in caches.values()]
        out = real(r, slot, caches, table_row, prefix_len, rows0)
        for (k, v), c in zip(before, out[1].values()):
            assert torch.equal(c.k[:, shared], k)
            assert torch.equal(c.v[:, shared], v)
        checked.append(shared)
        return out

    srv._prefill_suffix = watched
    srv.generate(reqs)
    assert len(checked) == 4 and all(len(b) == 2 for b in checked)


def test_prefix_cache_refusals_match_reference_messages():
    with pytest.raises(ValueError,
                       match="prefix_cache=True needs the paged KV layout"):
        port_server.ServeConfig(prefix_cache=True, kv_block_size=0)
    sc = port_server.ServeConfig(max_len=32, kv_block_size=8,
                                 prefix_cache=True)
    dense = get_config("smollm-135m").reduced()
    for cfg, msg in [
        (get_config("deepseek-v3-671b").reduced(),
         "not supported for family 'moe'"),
        (dataclasses.replace(dense, family="vlm", frontend="patches"),
         "not supported for family 'vlm'"),
        (dataclasses.replace(dense, family="ssm"),
         "needs the paged KV layout"),
    ]:
        with pytest.raises(ValueError, match=msg):
            port_server.Server(cfg, None, sc, device="cpu")
    moe = get_config("deepseek-v3-671b").reduced()
    mparams = port_model.init_params(moe, seed=0, device="cpu")
    with pytest.raises(ValueError, match="continuation prefill is not "
                                         "supported for family 'moe'"):
        port_model.forward(mparams, moe,
                           {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                           port_model.init_caches(moe, 1, 8, device="cpu"),
                           continuation=True)
    with pytest.raises(NotImplementedError, match="MLA attention"):
        port_attn.mla_forward(
            mparams["dense_stack"][0]["attn"], torch.zeros((1, 4, 64)),
            torch.zeros((1, 4), dtype=torch.int32), moe, continuation=True)


def test_launcher_prefix_flags_match_reference_launcher(capsys, monkeypatch):
    """``--prefix-cache --shared-prefix-len 16 --prefill-buckets ...`` on
    the reduced config: the port's launcher (on the CPU, the reference's
    weights through the bridge) prints the reference launcher's tokens
    and prefix-cache lines."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve

    def bridged_init(cfg, seed=0, device="cuda"):
        ref_cfg = ref_get_config(cfg.name).reduced()
        assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
        return params_from_reference(jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(ref_cfg,
                                              jax.random.PRNGKey(seed))),
            device=device)

    monkeypatch.setattr(port_model, "init_params", bridged_init)
    argv = ["--arch", "smollm-135m", "--reduced", "--requests", "4",
            "--prompt-len", "8", "--max-new", "4", "--batch-slots", "2",
            "--max-len", "64", "--mixed", "--kv-block-size", "8",
            "--prefix-cache", "--shared-prefix-len", "16",
            "--prefill-buckets", "8,16,32,64"]
    ref_serve.main(argv + ["--attn-kernel", "paged"])
    ref_lines = capsys.readouterr().out.splitlines()
    port_serve.main(argv + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()

    def picked(lines):
        outs = [re.search(r"tokens=.*", ln).group(0) for ln in lines
                if "out=" in ln]
        return outs, [ln for ln in lines if "prefix " in ln]

    ref_outs, ref_prefix = picked(ref_lines)
    port_outs, port_prefix = picked(port_lines)
    assert len(ref_outs) == 3 and len(ref_prefix) == 2
    assert port_outs == ref_outs and port_prefix == ref_prefix
    assert "3/4 admissions hit" in port_prefix[0]
