"""The port's configs, parameter bridge and import boundary.

The port must mirror the reference's configs field for field, carry the
reference's weights over exactly, and never import the reference
package or its framework.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.sparse_ops import SparsityConfig as RefSparsityConfig
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.models import model as model_lib
from repro_torch.models import modules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_reference(reduced):
    ref = ref_get_config("smollm-135m")
    port = get_config("smollm-135m")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert _as_dict(port) == _as_dict(ref)
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.n_params() == ref.n_params()


NEW_ARCHS = ("smollm-360m", "mistral-nemo-12b", "qwen1.5-110b",
             "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_new_config_fields_equal_reference(name, reduced):
    """The configs ported with the contiguous layout and the ssm and
    hybrid families, field for field, full and reduced."""
    ref, port = ref_get_config(name), get_config(name)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert _as_dict(port) == _as_dict(ref)
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.n_params() == ref.n_params()
    assert port.n_params_active() == ref.n_params_active()


@pytest.mark.parametrize("value", [0.0, 0.03, 0.1, 0.3, 0.5, 0.9, 1.2, -1])
def test_sparsity_config_snap_equals_reference(value):
    port = SparsityConfig(expected_sparsity=value)
    ref = RefSparsityConfig(expected_sparsity=value)
    assert _as_dict(port) == _as_dict(ref)
    assert port.expected_sparsity * 8 == round(port.expected_sparsity * 8)


def test_sparsity_config_fields_and_validation_equal_reference():
    assert [f.name for f in dataclasses.fields(SparsityConfig)] == \
        [f.name for f in dataclasses.fields(RefSparsityConfig)]
    assert _as_dict(SparsityConfig()) == _as_dict(RefSparsityConfig())
    with pytest.raises(ValueError, match="gate_threshold"):
        SparsityConfig(gate_threshold=-0.1)


def test_registry_knows_only_ported_archs():
    """Every arch of the reference's registry is ported: the registry's
    names are the reference's, and the vlm and audio configs equal the
    reference's field for field (full and reduced)."""
    from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
    from repro_torch.configs import ARCH_NAMES
    assert ARCH_NAMES == REF_ARCH_NAMES
    for name in ("pixtral-12b", "musicgen-large"):
        for port, ref in ((get_config(name), ref_get_config(name)),
                          (get_config(name).reduced(),
                           ref_get_config(name).reduced())):
            assert _as_dict(port) == _as_dict(ref)
            assert port.n_params() == ref.n_params()
    with pytest.raises(KeyError, match="serves"):
        get_config("no-such-arch")


@pytest.mark.parametrize("name", ["pixtral-12b", "musicgen-large"])
def test_bridged_frontend_trees_exact(name):
    """The audio frontend's per-codebook ``embed`` (K, V, d) and
    ``heads`` (K, d, V), and the vlm's text tree, cross the bridge bit
    for bit with the shapes and dtypes of the port's own init."""
    ref_cfg = dataclasses.replace(ref_get_config(name).reduced(),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(0)))
    port = bridge.params_from_reference(ref_params, device="cpu")
    own = model_lib.init_params(cfg, seed=0, device="cpu")
    assert sorted(port) == sorted(own)
    for a, b in zip(modules.iter_leaves(port), modules.iter_leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype
    if cfg.frontend == "codes":
        K, V, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
        assert tuple(port["embed"].shape) == (K, V, d)
        assert tuple(port["heads"].shape) == (K, d, V)
        assert "head" not in port
    np.testing.assert_array_equal(
        port["embed"].view(torch.int16).numpy(),
        ref_params["embed"].view(np.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridged_leaves_exact_with_shapes_and_dtypes(dtype):
    _check_bridged_tree(dtype=dtype)


def test_bridged_relu_tree_exact_in_bf16():
    """The relu MLP's tree (``--sparce`` swaps it in) has no w_gate and
    crosses the bridge bit for bit."""
    port = _check_bridged_tree(dtype="bfloat16", mlp_act="relu")
    mlp = port["stack"][0]["mlp"]
    assert sorted(mlp) == ["w_in", "w_out"]
    assert mlp["w_in"].dtype == torch.bfloat16


def _check_bridged_tree(**cfg_fields):
    ref_cfg = dataclasses.replace(ref_get_config("smollm-135m").reduced(),
                                  **cfg_fields)
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              **cfg_fields)
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(0)))
    port = bridge.params_from_reference(ref_params, device="cpu")
    own = model_lib.init_params(cfg, seed=0, device="cpu")
    assert len(port["stack"]) == cfg.num_layers

    def check(ref_leaf, bridged, own_leaf):
        assert tuple(bridged.shape) == tuple(own_leaf.shape)
        assert bridged.dtype == own_leaf.dtype
        assert str(bridged.dtype).replace("torch.", "") == \
            ref_leaf.dtype.name
        bits = (bridged.view(torch.int16) if bridged.dtype == torch.bfloat16
                else bridged).numpy()
        want = (ref_leaf.view(np.int16) if ref_leaf.dtype.name == "bfloat16"
                else ref_leaf)
        np.testing.assert_array_equal(bits, want)  # bit for bit

    for key in ("embed",):
        check(ref_params[key], port[key], own[key])
    check(ref_params["final_norm"]["scale"], port["final_norm"]["scale"],
          own["final_norm"]["scale"])
    flat = jax.tree_util.tree_flatten_with_path(ref_params["stack"])[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        for i in range(cfg.num_layers):
            b, o = port["stack"][i], own["stack"][i]
            for k in keys:
                b, o = b[k], o[k]
            check(leaf[i], b, o)
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(ref_params))
    assert modules.param_count(port) == modules.param_count(own) == n_ref
    return port


def test_own_init_params_has_reference_scales():
    cfg = get_config("smollm-135m").reduced()
    p = model_lib.init_params(cfg, seed=3, device="cpu")
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    wq = p["stack"][0]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.02
    q2 = model_lib.init_params(cfg, seed=3, device="cpu")["stack"][0]
    assert torch.equal(q2["attn"]["wq"], wq)  # seeded


def test_init_values_depend_on_neither_threads_nor_staging(monkeypatch):
    """Each leaf's chunks come from generators keyed by (leaf seed, chunk
    index): drawing them on 4 threads into 4-chunk slabs, or one at a
    time, gives the same numbers."""
    cfg = get_config("smollm-135m").reduced()
    monkeypatch.setattr(modules, "CHUNK_VALUES", 1 << 10)
    got = []
    for threads, slab in ((4, 1 << 12), (1, 1 << 10)):
        monkeypatch.setattr(modules, "INIT_THREADS", threads)
        monkeypatch.setattr(modules, "SLAB_VALUES", slab)
        got.append(list(modules.iter_leaves(
            model_lib.init_params(cfg, seed=5, device="cpu"))))
    assert max(p.numel() for p in got[0]) > 4 << 10  # several slabs
    for x, y in zip(*got):
        assert torch.equal(x, y)


_IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:\.|\s|$)",
                        re.MULTILINE)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_source_scan_finds_no_reference_or_jax_imports():
    files = _port_sources()
    assert len(files) > 20
    dynamic = re.compile(
        r"(?:import_module|__import__)\(\s*[\"'](jax|repro)(?:[.\"'])")
    for path in files:
        text = open(path).read()
        hits = _IMPORT_RE.findall(text) + dynamic.findall(text)
        assert not hits, f"{path} imports {hits}"


def test_importing_the_port_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.bridge, repro_torch.launch.serve\n"
        "import repro_torch.runtime.server, repro_torch.models.model\n"
        "import repro_torch.kernels.ops, repro_torch.configs\n"
        "import repro_torch.parallel.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.parallel.collectives\n"
        "import repro_torch.parallel.worker\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_server_without_device_raises_on_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.runtime.server import ServeConfig, Server
    cfg = get_config("smollm-135m").reduced()
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, params, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_reference({"embed": np.zeros((2, 2), np.float32)})
