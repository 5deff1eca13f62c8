"""The port's mamba2 mixer and the ssm family against the reference.

The same inputs, drawn with numpy from a seed, go through the
reference's functions (``repro/models/ssm.py``) and the port's
(``repro_torch/models/ssm.py``): the causal conv, the chunked SSD scan
(also with a chunk of large ``dt``, whose anti-causal decay must be
masked before the exp), and the mixer in prefill and in recurrent
decode, in f32, within 1e-5 (sums in another order). The reduced
``mamba2-2.7b`` serves on the reference's engine and the port's,
contiguously, to the same tokens and metrics; its decode steps equal the
full forward; a prompt longer than one chunk and not a whole number of
chunks is refused by both with the same exception type; the param tree
crosses the bridge bit for bit and the port's own ``init_params`` draws
the reference's shapes and dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.runtime import server as ref_server
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import model as port_model
from repro_torch.models import ssm as port_ssm
from repro_torch.runtime import server as port_server
from serving_harness import Traffic, make_traffic
from test_torch_server import EXACT_FIELDS

ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums in another order


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors are tiny: one intra-op thread keeps the port's CPU
    steps from paying a thread pool's wake-ups per op."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**fields):
    return (dataclasses.replace(ref_get_config(ARCH).reduced(), **fields),
            dataclasses.replace(get_config(ARCH).reduced(), **fields))


def _bridged(ref_cfg, seed=0):
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return params, params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ the mixer
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x, w, b = _normal(rng, 2, 7, 12), _normal(rng, 4, 12), _normal(rng, 12)
    st = _normal(rng, 2, 3, 12) if with_state else None
    want, want_st = ref_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = port_ssm._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st))
    _close(got, want)
    _close(got_st, want_st)


@pytest.mark.parametrize("L,chunk,dt_scale", [
    (16, 16, 0.5),    # one chunk
    (48, 16, 0.5),    # three chunks: the inter-chunk recurrence
    (8, 16, 0.5),     # shorter than one chunk
    (32, 16, 10.0),   # large dt: anti-causal exps overflow unless masked
], ids=["one-chunk", "three-chunks", "short", "large-dt"])
def test_ssd_chunked_matches_reference(L, chunk, dt_scale):
    rng = np.random.default_rng(1)
    b, H, P, G, N = 2, 4, 8, 1, 16
    x = _normal(rng, b, L, H, P)
    dt = np.abs(_normal(rng, b, L, H, scale=dt_scale))
    A_log = _normal(rng, H, scale=0.5)
    B, C = _normal(rng, b, L, G, N), _normal(rng, b, L, G, N)
    D = _normal(rng, H)
    want_y, want_h = ref_ssm._ssd_chunked(
        *map(jnp.asarray, (x, dt, A_log, B, C, D)), chunk)
    got_y, got_h = port_ssm._ssd_chunked(
        *map(torch.from_numpy, (x, dt, A_log, B, C, D)), chunk)
    assert bool(torch.isfinite(got_y).all())
    assert bool(torch.isfinite(got_h).all())
    # Large dt drives y to O(1e2-1e3): the same f32 sums in another order,
    # relative to those magnitudes.
    tol = dict(rtol=1e-4, atol=1e-4) if dt_scale > 1 else TOL
    _close(got_y, want_y, **tol)
    _close(got_h, want_h, **tol)


def test_mixer_prefill_and_decode_match_reference():
    """``mamba2_forward`` without a cache, then from a zero cache over a
    prompt, then three recurrent decode steps."""
    ref_cfg, cfg = _cfgs()
    s = cfg.ssm
    p_ref = ref_ssm.mamba2_init(jax.random.PRNGKey(3), ref_cfg, jnp.float32)
    p_ref = dict(p_ref, dt_bias=jnp.full(p_ref["dt_bias"].shape, 0.3),
                 A_log=jnp.linspace(-1.0, 1.0, p_ref["A_log"].shape[0]))
    p = params_from_reference(
        {"m": jax.tree_util.tree_map(np.asarray, p_ref)}, device="cpu")["m"]
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 2 * s.chunk, cfg.d_model)
    want, _ = ref_ssm.mamba2_forward(p_ref, jnp.asarray(x), ref_cfg)
    got, _ = port_ssm.mamba2_forward(p, torch.from_numpy(x), cfg)
    _close(got, want)
    ref_c = ref_ssm.mamba2_init_cache(ref_cfg, 2, jnp.float32)
    c = port_ssm.SSMCache(*(f[0] for f in port_ssm.mamba2_init_cache(
        cfg, 2, torch.float32, "cpu")))
    want, ref_c = ref_ssm.mamba2_forward(p_ref, jnp.asarray(x), ref_cfg,
                                         cache=ref_c)
    got, c = port_ssm.mamba2_forward(p, torch.from_numpy(x), cfg, cache=c)
    _close(got, want)
    for _ in range(3):
        x1 = _normal(rng, 2, 1, cfg.d_model)
        want, ref_c = ref_ssm.mamba2_forward(p_ref, jnp.asarray(x1),
                                             ref_cfg, cache=ref_c)
        got, c = port_ssm.mamba2_forward(p, torch.from_numpy(x1), cfg,
                                         cache=c)
        _close(got, want)
        _close(c.conv, ref_c.conv)
        _close(c.h, ref_c.h)


def test_decode_matches_full_forward():
    """Prefill a prompt into contiguous caches, then decode token by
    token: every step's logits equal the full forward's at that
    position (f32, sums in another order)."""
    ref_cfg, cfg = _cfgs()
    _, params = _bridged(ref_cfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 2 * 16)))  # two whole chunks
    with torch.no_grad():
        full, _, _ = port_model.forward(params, cfg, {"tokens": toks})
        logits, caches = port_model.prefill(params, cfg,
                                            {"tokens": toks[:, :16]}, 32)
        torch.testing.assert_close(logits[:, -1], full[:, 15], **TOL)
        for t in range(16, toks.shape[1]):
            logits, caches = port_model.decode_step(params, cfg,
                                                    toks[:, t:t + 1], caches)
            torch.testing.assert_close(logits[:, 0], full[:, t], **TOL)


def test_prompt_longer_than_a_chunk_is_refused_by_both():
    """The reference's scan takes a prompt shorter than one chunk or a
    whole number of chunks; 20 rows against chunk 16 fail its assertion,
    in ``forward`` and in the engine's prefill, and the port's alike."""
    ref_cfg, cfg = _cfgs()
    ref_params, params = _bridged(ref_cfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 20))
    with pytest.raises(AssertionError):
        ref_model.forward(ref_params, ref_cfg,
                          {"tokens": jnp.asarray(toks, jnp.int32)})
    with pytest.raises(AssertionError):
        port_model.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    req = dict(uid=0, prompt=toks[0], max_new=2)
    with pytest.raises(AssertionError):
        ref_server.Server(ref_cfg, ref_params, ref_server.ServeConfig(
            batch_slots=2, max_len=32)).generate([ref_server.Request(**req)])
    with pytest.raises(AssertionError):
        port_server.Server(cfg, params, port_server.ServeConfig(
            batch_slots=2, max_len=32), device="cpu").generate(
                [port_server.Request(**req)])


# ------------------------------------------------------------ the engine
def serve_both(ref_cfg, cfg, traffic, *, slots=3, max_len=32, **sc):
    """The reference's engine and the port's on the same bridged weights
    and seeded harness traffic; returns (ref_srv, ref_done, srv, done)."""
    ref_params, params = _bridged(ref_cfg)
    reqs = make_traffic(ref_cfg, traffic)
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_server.ServeConfig(
        batch_slots=slots, max_len=max_len, **sc))
    ref_done = ref_srv.generate(
        [dataclasses.replace(r, out=None, stats={}) for r in reqs])
    srv = port_server.Server(cfg, params, port_server.ServeConfig(
        batch_slots=slots, max_len=max_len, **sc), device="cpu")
    done = srv.generate([
        port_server.Request(uid=r.uid, prompt=np.asarray(r.prompt),
                            max_new=r.max_new, eos_id=r.eos_id)
        for r in reqs])
    return ref_srv, ref_done, srv, done


def assert_same_serving(ref_srv, ref_done, srv, done):
    """Tokens, completion and admission order and every exact metric."""
    assert {r.uid: np.asarray(r.out).tolist() for r in done} == {
        r.uid: np.asarray(r.out).tolist() for r in ref_done}
    assert [r.uid for r in done] == [r.uid for r in ref_done]
    assert list(srv.admitted_uids) == list(ref_srv.admitted_uids)
    for name in EXACT_FIELDS:
        assert getattr(srv.metrics, name) == getattr(ref_srv.metrics,
                                                     name), name


@pytest.mark.parametrize("kv_block_size", [0, 16],
                         ids=["contiguous", "falls-back"])
def test_engine_matches_reference(kv_block_size):
    """The ssm family serves contiguously whatever the block size, as
    the reference's does; prompts within one chunk or a whole number of
    chunks (the reduced chunk is 16)."""
    ref_cfg, cfg = _cfgs()
    traffic = Traffic(n_requests=6, prompt_lens=(2, 16), max_new=(1, 8),
                      seed=kv_block_size, eos_prob=0.3)
    ref_srv, ref_done, srv, done = serve_both(
        ref_cfg, cfg, traffic, kv_block_size=kv_block_size)
    assert_same_serving(ref_srv, ref_done, srv, done)
    assert srv.metrics.kv_paged == 0 and srv._st.alloc is None


# ------------------------------------------------------- the param tree
def restack(tree):
    """The port's param tree in the reference's layout: lists of layer
    dicts stacked on a leading axis (lists of lists on two), numpy."""
    if isinstance(tree, dict):
        return {k: restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        items = [restack(v) for v in tree]
        return jax.tree_util.tree_map(lambda *a: np.stack(a), *items)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def leaf_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(np.shape(a)),
                                      np.dtype(a.dtype).name)
            for p, a in flat}


def check_tree(arch, **fields):
    """Bridge round trip bit for bit in bf16, and ``init_params``'
    shapes and dtypes equal to the reference tree's, leaf by leaf."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="bfloat16", **fields)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16",
                              **fields)
    ref_np = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(0)))
    back = restack(params_from_reference(ref_np, device="cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref_np)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref_np)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    own = restack(port_model.init_params(cfg, seed=0, device="cpu"))
    assert leaf_specs(own) == leaf_specs(ref_np)


def test_param_tree_round_trip_and_init_shapes():
    check_tree(ARCH)
