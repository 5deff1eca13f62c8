"""The port's hybrid family (zamba2) against the reference.

Each super-group is ``attn_every`` mamba2 layers followed by the ONE
shared attention+MLP block: one set of weights, but every application
keeps its own KV cache. ``zamba2-7b``'s ``reduced()`` has 2 layers with
``attn_every`` 2, so one group and no trailing layer: a port that kept
one KV cache for all applications, or copied the block's weights per
group, would pass there. So every test also runs 5 layers on both sides
(2 groups and 1 trailing ssm layer). The same weights (bridged) and
tokens go through the reference's forward and the port's (f32, within
1e-5); decode steps equal the full forward; the engines serve seeded
harness traffic to the same tokens and metrics; the param tree crosses
the bridge bit for bit and ``init_params`` draws the reference's shapes
and dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.models import model as port_model
from serving_harness import Traffic
from test_torch_ssm import TOL, assert_same_serving, check_tree, serve_both

ARCH = "zamba2-7b"
# reduced(): one group, no trailing layer; 5 layers: two groups sharing
# the block, each with its own KV cache, and a trailing ssm layer.
DEPTHS = [pytest.param({}, id="reduced"),
          pytest.param(dict(num_layers=5), id="5-layers")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(fields):
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), **fields)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **fields)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


@pytest.mark.parametrize("fields", DEPTHS)
def test_forward_and_decode_match_reference(fields):
    """A 16-token prefill into contiguous caches, then three decode
    steps: logits and every cache leaf (ssm states and conv windows, the
    KV cache of each application of the shared block, its lengths)."""
    ref_cfg, cfg, ref_params, params = _setup(fields)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    want, ref_c = ref_model.prefill(
        ref_params, ref_cfg, {"tokens": jnp.asarray(toks, jnp.int32)}, 32)
    with torch.no_grad():
        got, c = port_model.prefill(params, cfg,
                                    {"tokens": torch.from_numpy(toks)}, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, (2, 1))
        want, ref_c = ref_model.decode_step(ref_params, ref_cfg,
                                            jnp.asarray(t, jnp.int32), ref_c)
        with torch.no_grad():
            got, c = port_model.decode_step(params, cfg,
                                            torch.from_numpy(t), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_c)
    got_leaves = port_model.cache_leaves(c)
    assert len(got_leaves) == len(ref_leaves)
    n_super = cfg.num_layers // cfg.attn_every
    assert c["hybrid"]["attn"].k.shape[0] == n_super
    for t, (path, a) in zip(got_leaves, ref_leaves):
        assert tuple(t.shape) == a.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(t.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("fields", DEPTHS)
def test_decode_matches_full_forward(fields):
    _, cfg, _, params = _setup(fields)
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


@pytest.mark.parametrize("fields", DEPTHS)
def test_engine_matches_reference(fields):
    """Contiguous caches, as the reference serves the hybrid family
    whatever the block size (the default 16 here)."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), **fields)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **fields)
    traffic = Traffic(n_requests=5, prompt_lens=(2, 16), max_new=(1, 8),
                      seed=2)
    ref_srv, ref_done, srv, done = serve_both(ref_cfg, cfg, traffic)
    assert_same_serving(ref_srv, ref_done, srv, done)
    assert srv.metrics.kv_paged == 0


@pytest.mark.parametrize("fields", DEPTHS)
def test_param_tree_round_trip_and_init_shapes(fields):
    check_tree(ARCH, **fields)
