"""The plain reference against the port at the configurations' reduced
sizes, on the CPU in f32: logits of a full forward, prefill and decode
through the reference's plain cache, the training loss and every
gradient, and one AdamW update."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import rehearse  # noqa: E402

from perfbench import weights  # noqa: E402
from perfbench.reference import adamw as ref_adamw  # noqa: E402
from perfbench.reference import llama  # noqa: E402
from perfbench.systems import serve as serve_sys  # noqa: E402

CELLS = ["nemo12b.rag.batch", "smollm135m.train.s2048"]


def small(name):
    return rehearse.small_cell(name).config


@pytest.mark.parametrize("name", CELLS)
def test_forward_logits_match_port(name):
    from repro_torch.models import model as model_lib
    config = small(name)
    cfg = serve_sys.arch_config(config)
    params = serve_sys.make_weights(config, seed=11, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, config["model"]["vocab_size"], (2, 19)))
    want, _, _ = model_lib.forward(params, cfg, {"tokens": toks})
    got = llama.logits_at(params, config["model"], list(toks),
                          [torch.arange(19)] * 2)
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], rtol=1e-4, atol=1e-4)


def test_decode_through_plain_cache_equals_full_forward():
    config = small("nemo12b.rag.batch")
    params = serve_sys.make_weights(config, seed=3, device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, config["model"]["vocab_size"], 9))
    toks = llama.decode_greedy(params, config["model"], prompt, 6)
    seq = torch.cat([prompt, torch.as_tensor(toks[:-1])])
    (z,) = llama.logits_at(params, config["model"], [seq],
                           [torch.arange(8, 8 + 6)])
    assert z.argmax(-1).tolist() == toks


def test_serve_engine_greedy_equals_reference_decode():
    """The port's engine at f32 serves the reference's greedy tokens."""
    from repro_torch.runtime.server import Request, Server, ServeConfig
    config = small("nemo12b.rag.batch")
    cfg = serve_sys.arch_config(config)
    params = serve_sys.make_weights(config, seed=5, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n) for n in (5, 12, 30)]
    srv = Server(cfg, params, ServeConfig(batch_slots=2, max_len=64,
                                          attn_kernel="paged"),
                 device="cpu")
    out = srv.generate([Request(uid=i, prompt=p, max_new=7)
                        for i, p in enumerate(prompts)])
    for r in out:
        want = llama.decode_greedy(params, config["model"],
                                   torch.as_tensor(prompts[r.uid]), 7)
        assert [int(t) for t in r.out] == want


def test_training_loss_grads_and_update_match_port():
    from repro_torch.models import model as model_lib
    from repro_torch.models.modules import iter_leaves, tree_map
    from repro_torch.optim.adamw import AdamW
    config = small("smollm135m.train.s2048")
    cfg = serve_sys.arch_config(config)
    params = serve_sys.make_weights(config, seed=7, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (3, 17)))
    for p in iter_leaves(params):
        p.requires_grad_(True)
    want, _ = model_lib.loss_fn(params, cfg, {"tokens": toks})
    want.backward()
    names = [k for k, _ in weights.iter_named(params)]
    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in weights.iter_named(params)}
    tree = _tree(params, flat)
    got = llama.loss_sum(tree, config["model"], toks) / (3 * 16)
    got.backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for k, p in weights.iter_named(params):
        torch.testing.assert_close(flat[k].grad, p.grad, rtol=1e-4,
                                   atol=1e-6)
    hp = config["optimizer"]
    grads = tree_map(lambda p: p.grad, params)
    with torch.no_grad():
        new, _, _ = AdamW(**hp).update(grads, AdamW(**hp).init(params),
                                       params)
    # The same gradients into both optimizers (Adam's first step is about
    # lr * sign(g), so where |g| is near eps the gradients' own rounding
    # would move it).
    port_grads = dict(weights.iter_named(grads))
    opt = ref_adamw.AdamW([flat[k].detach().clone() for k in names], hp)
    opt.step([port_grads[k] for k in names])
    for k, v in weights.iter_named(new):
        torch.testing.assert_close(opt.p[names.index(k)], v, rtol=1e-6,
                                   atol=1e-8)


def _tree(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, flat, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def test_weights_are_seeded_and_scaled():
    config = small("nemo12b.rag.batch")
    a = serve_sys.make_weights(config, seed=9, device="cpu")
    b = serve_sys.make_weights(config, seed=9, device="cpu")
    c = serve_sys.make_weights(config, seed=10, device="cpu")
    for (k, x), (_, y), (_, z) in zip(weights.iter_named(a),
                                      weights.iter_named(b),
                                      weights.iter_named(c)):
        assert torch.equal(x, y), k
        if k.endswith("scale"):
            assert torch.equal(x, torch.ones_like(x))
            continue
        assert not torch.equal(x, z), k
        want = 0.02 if k == "embed" else x.shape[0] ** -0.5
        assert abs(float(x.float().std()) / want - 1) < 0.2, k


def test_reference_imports_nothing_of_the_program():
    """The reference's modules import torch and the standard library
    only: no jax, no repro, no repro_torch, nothing of the harness."""
    ref = Path(llama.__file__).parent
    for f in ref.glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top in ("torch", "__future__", "contextlib",
                               "typing", "math"), (f.name, n)
