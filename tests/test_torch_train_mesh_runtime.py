"""Training on a mesh end to end, against the single-host port and the
reference: the Trainer, its restart and elastic checkpoints, the train
launcher's ``--mesh``, expert-parallel MoE and the compressed
all-reduce (gloo ranks on the CPU, spawned by
``launch/mesh.py:spawn_mesh``; every process group with a timeout, every
spawn with a deadline).

- ``Trainer(mesh=...)`` on (2, 2): its history equals the single-host
  Trainer's; a fault raised on every rank at the same step restores the
  last checkpoint on every rank and replays; the data replicas' params
  stay bit-identical. A (2, 2) ZeRO-1 run saves; (1, 4) and one host
  restore it and continue to the history of an uninterrupted run. A
  checkpoint's leaves are assembled on rank 0 alone, each distinct
  block sent once.
- ``launch/train.py --mesh 2,2 [--zero1]`` and ``--mesh 4`` print the
  single host's step lines, and one ``mesh:`` line.
- ``_moe_forward_ep`` on (2, 4) against the reference's on conftest's 8
  host devices with a skewed router, so per-shard capacity drops
  assignments: the kept assignments count equal, the slot sparsity, y,
  the aux loss and the gradients of ``sum(y**2) + aux`` allclose; and
  against the port's global path where nothing drops.
- ``compressed_psum`` on 4 ranks against the reference's inside a
  ``shard_map`` on a 4-device sub-mesh (int8 and 1-bit, two rounds of
  error feedback): the averages, the residuals and ``wire_bytes``; the
  all-gather counters carry the int8 payload.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.launch import mesh as ref_mesh_lib
from repro.models import moe as ref_moe
from repro.optim import compress as ref_compress
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as port_train
from repro_torch.models import moe as moe_lib
from repro_torch.optim import compress
import torch_train_scenarios as ts

TIMEOUT_S = 30.0
DEADLINE_S = 240.0
TRAIN = dict(arch="smollm-135m", B=4, S=16, steps=6)
# Params after 6 Adam steps of lr 1e-3: Adam's normalized step turns the
# sum-order noise of a gradient near zero into up to lr a step, so they
# agree within a tenth of lr (the losses within f32 rounding).
PARAM_ATOL = 1e-4


def _spawn(fn, shape, specs):
    return mesh_lib.spawn_mesh(fn, shape, (specs,),
                               axes=("pod", "data", "model")[-len(shape):],
                               timeout_s=TIMEOUT_S, deadline_s=DEADLINE_S)


def _losses(history):
    return [h["loss"] for h in history if "loss" in h]


def test_trainer_on_a_mesh_restarts_and_restores_elastically(tmp_path):
    """One (2, 2) spawn: an uninterrupted run, a run with a fault at
    step 4 (checkpoints every 2 steps), and a ZeRO-1 run that saves at
    step 3; then (1, 4) and one host restore that save."""
    single = ts.run_trainer(dict(TRAIN, name="single"))
    want = _losses(single["history"])
    assert len(want) == 6 and want[-1] < want[0]
    fault_dir, save_dir = str(tmp_path / "fault"), str(tmp_path / "save")
    outs = _spawn(ts.trainer_rank, (2, 2), [
        dict(TRAIN, name="plain"),
        dict(TRAIN, name="fault", ckpt_dir=fault_dir, ckpt_every=2,
             fault_at=4),
        dict(TRAIN, name="save", zero1=True, steps=3, ckpt_dir=save_dir)])
    plain, fault, save = outs[0]
    np.testing.assert_allclose(_losses(plain["history"]), want, rtol=1e-5)
    for a, b in zip(plain["params"], single["params"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=PARAM_ATOL)
    # The data replicas hold the same bits; the model shards differ.
    for k in range(3):
        assert outs[0][k]["digest"] == outs[2][k]["digest"]
        assert outs[1][k]["digest"] == outs[3][k]["digest"]
        assert outs[0][k]["digest"] != outs[1][k]["digest"]
    # The fault: every rank restored step 4's checkpoint and replayed.
    for rank in outs:
        events = [h for h in rank[1]["history"] if h.get("event")]
        assert len(events) == 1 and rank[1]["final_step"] == 6
    np.testing.assert_allclose(_losses(fault["history"]),
                               want[:4] + want[4:], rtol=1e-5)
    assert save["final_step"] == 3
    # Elastic: (1, 4) and one host continue the (2, 2) ZeRO-1 save.
    dirs = []
    for name in ("m14", "one"):
        d = str(tmp_path / name)
        shutil.copytree(save_dir, d)
        dirs.append(d)
    cont = dict(TRAIN, start=3)
    res14 = _spawn(ts.trainer_rank, (1, 4), [dict(cont, ckpt_dir=dirs[0])])
    one = ts.run_trainer(dict(cont, ckpt_dir=dirs[1]))
    for res in (res14[0][0], one):
        hist = [h for h in res["history"] if "loss" in h]
        assert [h["step"] for h in hist] == [3, 4, 5]
        np.testing.assert_allclose(_losses(save["history"]) +
                                   _losses(res["history"]), want, rtol=1e-5)
        for a, b in zip(res["params"], single["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=PARAM_ATOL)
    assert sorted(os.listdir(save_dir)) == ["LATEST", "step_00000003"]


def _step_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("step ")]


def _nums(ln):
    return [float(t) for t in ln.split()[1::2]]


def test_checkpoint_gathers_to_rank_zero_only():
    """``gather_to_root`` on (2, 1, 2): rank 0 assembles every leaf whole
    (bf16 and f32, specs over one axis, two axes and none); the other
    ranks get nothing; each distinct block crosses the wire once, in one
    send per rank and dtype, and nothing is all-gathered."""
    shape = (2, 1, 2)
    outs = _spawn(ts.gather_rank, shape, [dict(device="cpu")])
    mesh = ts.shd.Mesh(dict(zip(("pod", "data", "model"), shape)))
    whole = ts.gather_leaves(mesh)
    got = outs[0][0]["leaves"]
    for a, b in zip(got, ts._np(whole)):
        np.testing.assert_array_equal(a, b)
    # Distinct blocks not on rank 0, in bytes: every leaf but the
    # replicated ones, less rank 0's own block.
    want = 0
    for a, spec in zip(whole, ts.GATHER_SPECS):
        blocks = len({ts.shd.block_index(spec, mesh, r)
                      for r in range(mesh.size)})
        if blocks > 1:
            want += a.numel() * a.element_size() * (blocks - 1) // blocks
    recv = outs[0][0]["stats"]
    assert recv["all-gather"] == 0
    assert recv["collective-permute"] == want
    sent = sum(o[0]["stats"]["collective-permute"] for o in outs[1:])
    assert sent == want
    for o in outs[1:]:
        assert o[0]["leaves"] is None
        assert o[0]["stats"]["counts"]["collective-permute"] <= 2  # dtypes


@pytest.mark.parametrize("mesh", ["2,2", "2,2 zero1", "4"])
def test_train_launcher_on_a_mesh_prints_the_single_host_lines(capfd, mesh):
    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "3",
            "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
            "--warmup", "2", "--lr", "1e-3", "--device", "cpu"]
    port_train.main(argv)
    single = capfd.readouterr().out
    dims, *flags = mesh.split()
    out = port_train.main(argv + ["--mesh", dims, "--mesh-timeout", "30"]
                          + [f"--{f}" for f in flags])
    text = capfd.readouterr().out
    want, got = _step_lines(single), _step_lines(text)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(_nums(a), _nums(b), rtol=1e-3)
    assert "done: 3 steps" in text
    mesh_lines = [ln for ln in text.splitlines() if ln.startswith("mesh: ")]
    assert len(mesh_lines) == 1 and "all-reduce=" in mesh_lines[0]
    assert out["final_step"] == 3


# ------------------------------------------------------------------ EP
def _moe_case(skewed: bool, B: int, S: int, seed: int = 0):
    cfg = ref_get_config("deepseek-v3-671b").reduced()
    params = ref_moe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.3).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    if skewed:
        # Every token's top-2 holds expert 0: its load overflows the
        # per-shard capacity and the tail of its assignments drops.
        x[..., 0] += 2.0
        params["router"] = params["router"].copy()
        params["router"][0, 0] = 4.0
    return cfg, params, x


def _ref_ep(cfg, params, x, mesh):
    def loss(p, xx):
        y, aux, ss = ref_moe._moe_forward_ep(p, xx, cfg, mesh, ("data",))
        return jnp.sum(y ** 2) + aux, (y, aux, ss)
    (_, (y, aux, ss)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return y, aux, ss, g


def _port_leaves(tree):
    """The moe tree's leaves in the port's order (sorted keys)."""
    out = []
    for k in sorted(tree):
        out.extend(_port_leaves(tree[k]) if isinstance(tree[k], dict)
                   else [np.asarray(tree[k])])
    return out


@pytest.fixture(scope="module")
def ep_runs():
    cases = {"skewed": _moe_case(True, 4, 32), "even": _moe_case(False, 4, 8)}
    specs = [dict(arch="deepseek-v3-671b", params=p, x=x, name=n)
             for n, (_, p, x) in cases.items()]
    outs = _spawn(ts.ep_rank, (2, 4), specs)
    return cases, dict(zip(cases, outs[0]))


def test_ep_matches_reference_ep_with_drops(cpu_mesh, ep_runs):
    cases, runs = ep_runs
    cfg, params, x = cases["skewed"]
    got = runs["skewed"]
    mesh = ref_mesh_lib.make_mesh((2, 4), ("data", "model"))
    y, aux, ss, (gp, gx) = _ref_ep(cfg, params, x, mesh)
    E_loc = cfg.moe.num_experts // 4
    C = ref_moe.capacity((x.shape[0] // 2) * x.shape[1], cfg)
    kept = int(round((1.0 - float(ss)) * 8 * E_loc * C))
    assert got["kept"] == kept
    assert kept < 2 * x.shape[0] * x.shape[1]  # assignments dropped
    assert got["slot_sparsity"] == pytest.approx(float(ss), rel=1e-6)
    np.testing.assert_allclose(got["y"], np.asarray(y), rtol=1e-4,
                               atol=1e-5)
    assert got["aux"] == pytest.approx(float(aux), rel=1e-5)
    want = _port_leaves(jax.tree_util.tree_map(np.asarray, gp))
    for i, (a, b) in enumerate(zip(got["grads"], want)):
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"grad {i}")
    np.testing.assert_allclose(got["x_grad"], np.asarray(gx), rtol=1e-4,
                               atol=1e-5 * float(np.abs(gx).max()))
    assert got["stats"]["counts"]["all-reduce"] > 0


def test_ep_matches_port_global_path_without_drops(ep_runs):
    cases, runs = ep_runs
    cfg, params, x = cases["even"]
    got = runs["even"]
    from repro_torch.configs import get_config
    pcfg = get_config("deepseek-v3-671b").reduced()
    p = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
             {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
         for k, v in params.items()}
    leaves = [t for k in sorted(p) for t in (
        [p[k][kk] for kk in sorted(p[k])] if isinstance(p[k], dict)
        else [p[k]])]
    xt = torch.from_numpy(x)
    for t in leaves + [xt]:
        t.requires_grad_(True)
    y, aux, ss = moe_lib._moe_forward_global(p, xt, pcfg)
    assert float(ss) == pytest.approx(
        1.0 - 2 * x.shape[0] * x.shape[1]
        / (cfg.moe.num_experts * moe_lib.capacity(x.shape[0] * x.shape[1],
                                                  pcfg)))  # drop-free
    (torch.sum(y * y) + aux).backward()
    assert got["kept"] == 2 * x.shape[0] * x.shape[1]
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=1e-4,
                               atol=1e-6)
    assert got["aux"] == pytest.approx(float(aux), rel=1e-5)
    for i, (a, t) in enumerate(zip(got["grads"], leaves)):
        b = t.grad.numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=f"grad {i}")
    np.testing.assert_allclose(got["x_grad"], xt.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


# -------------------------------------------------- compressed_psum
@pytest.mark.parametrize("method", ["int8", "1bit"])
def test_compressed_psum_matches_reference(cpu_mesh, method):
    shape, n = (6, 10), 4
    rng = np.random.default_rng(3)
    rounds = [rng.standard_normal((n,) + shape).astype(np.float32)
              for _ in range(2)]
    mesh = JaxMesh(np.array(cpu_mesh[:n]), ("data",))

    def spmd(g, r):
        avg, new_r = ref_compress.compressed_psum(
            {"w": g[0]}, {"w": r[0]}, "data", method=method)
        return avg["w"][None], new_r["w"][None]

    fn = jax.jit(shard_map(spmd, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_rep=False))
    res = jnp.zeros((n,) + shape, jnp.float32)
    want = []
    for g in rounds:
        avg, res = fn(jnp.asarray(g), res)
        want.append((np.asarray(avg), np.asarray(res)))
    outs = mesh_lib.spawn_mesh(
        ts.compress_rank, (n,), ([dict(shape=shape, method=method,
                                    grads=rounds)],),
        axes=("data",), timeout_s=TIMEOUT_S, deadline_s=DEADLINE_S)
    for rank, out in enumerate(outs):
        got = out[0]
        for (a, r), (wa, wr) in zip(got["rounds"], want):
            np.testing.assert_allclose(a, wa[rank], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(r, wr[rank], rtol=1e-6, atol=1e-6)
        st = got["stats"]
        # One all-gather a leaf a round: the int8 q and its f32 scale.
        assert st["counts"]["all-gather"] == 2
        assert st["all-gather"] == 2 * (int(np.prod(shape)) + 4)
        assert st["all-reduce"] == 0
    params = {"a": torch.zeros(shape), "b": torch.zeros(64)}
    assert compress.wire_bytes(params, method) == ref_compress.wire_bytes(
        {"a": jnp.zeros(shape), "b": jnp.zeros(64)}, method)
    r0 = compress.init_residuals(params)
    assert all(float(t.abs().sum()) == 0 and t.dtype == torch.float32
               for t in r0.values())
