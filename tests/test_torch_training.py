"""The port's single-host training against the reference, on the CPU.

Same reduced configs, same weights (carried over by the bridge), same
numpy-seeded batches: ``loss_fn`` and every gradient (the SparCE ops'
autograd rules: the gated BP and WG GEMMs of ``sparce_matmul``, the
relu-family and GLU MLPs' dense recompute) equal ``jax.value_and_grad``
of the reference's within f32 tolerances, for the dense, moe (MLA, MoE
aux loss), ssm, hybrid, vlm and audio families and each sparsity mode
the reference can train; the relu-bitmap kernel's path is refused in
both. AdamW, its schedule, the data pipeline, the checkpoint manager,
the Trainer (histories, restarts, stragglers), activation checkpointing
and the train launcher behave as the reference's do.
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.core.sparse_ops import SparsityConfig as RefSparsityConfig
from repro.data import pipeline as ref_pipeline
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.runtime import trainer as ref_trainer
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.sparse_ops import SparsityConfig
from repro_torch.data import pipeline
from repro_torch.kernels import sparce_gemm as port_sg
from repro_torch.models import model as model_lib
from repro_torch.models.modules import iter_leaves
from repro_torch.optim import adamw
from repro_torch.runtime import trainer as port_trainer

# f32 tolerances for a loss and its gradients: the two frameworks sum in
# different orders, through a few layers.
RTOL, ATOL = 2e-4, 2e-6
SMALL = dict(block_m=8, block_k=32, block_n=32)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The tensors are tiny: few intra-op threads keep the CPU steps from
    paying a thread pool's wake-ups per op."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _configs(arch, **fields):
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    sp = fields.pop("sparsity", None)
    ref_cfg = dataclasses.replace(ref_cfg, **fields)
    cfg = dataclasses.replace(cfg, **fields)
    if sp is not None:
        ref_cfg = dataclasses.replace(ref_cfg,
                                      sparsity=RefSparsityConfig(**sp))
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(**sp))
    return ref_cfg, cfg


def _batch(cfg, B=2, S=16, seed=0, mask_tail=0):
    """Seeded numpy batch; ``mask_tail`` zeroes the loss mask on the last
    positions, whose gradients are then exactly zero in every layer (no
    later position reads them): whole error tiles for the BP gate."""
    rng = np.random.default_rng(seed)
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B,) + lead + (S,)).astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if mask_tail:
        mask = np.ones((B, S), np.float32)
        mask[:, S - mask_tail:] = 0.0
        batch["loss_mask"] = mask
    return batch


def _ref_value_and_grad(ref_cfg, ref_params, batch):
    (total, metrics), grads = jax.value_and_grad(
        ref_model.loss_fn, has_aux=True)(
            ref_params, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(total), {k: float(v) for k, v in metrics.items()}, grads


def _port_value_and_grad(cfg, params, batch):
    for p in iter_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    total, metrics = model_lib.loss_fn(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in iter_leaves(params)]
    return float(total), {k: float(v.detach()) for k, v in metrics.items()
                          }, grads


LOSS_CASES = {
    "dense-off": dict(arch="smollm-135m"),
    "relu-reference": dict(arch="smollm-135m", mlp_act="relu",
                           sparsity=dict(enabled=True, mode="reference",
                                         **SMALL)),
    "relu-fused": dict(arch="smollm-135m", mlp_act="relu",
                       sparsity=dict(enabled=True, mode="fused", **SMALL)),
    "relu2-fused": dict(arch="smollm-135m", mlp_act="relu2",
                        sparsity=dict(enabled=True, mode="fused", **SMALL)),
    "glu-kernel": dict(arch="smollm-135m", mask_tail=8,
                       sparsity=dict(enabled=True, mode="kernel", **SMALL)),
    "glu-fused": dict(arch="smollm-135m",
                      sparsity=dict(enabled=True, mode="fused", **SMALL)),
    "deepseek": dict(arch="deepseek-v3-671b"),
    "mamba2": dict(arch="mamba2-2.7b"),
    "zamba2": dict(arch="zamba2-7b"),
    "pixtral": dict(arch="pixtral-12b", mask_tail=4),
    "musicgen": dict(arch="musicgen-large", mask_tail=4),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradients_match_reference(case, monkeypatch):
    c = dict(LOSS_CASES[case])
    arch, mask_tail = c.pop("arch"), c.pop("mask_tail", 0)
    ref_cfg, cfg = _configs(arch, **c)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    batch = _batch(cfg, mask_tail=mask_tail)
    want_total, want_m, ref_grads = _ref_value_and_grad(ref_cfg, ref_params,
                                                        batch)
    gated = []
    real = port_sg.sparce_gemm_gated

    def counting(x, w, bits, **kw):
        gated.append((tuple(x.shape), int(bits.sum())))
        return real(x, w, bits, **kw)
    monkeypatch.setattr(port_sg, "sparce_gemm_gated", counting)
    params = params_from_reference(np_params, device="cpu")
    total, metrics, grads = _port_value_and_grad(cfg, params, batch)
    assert total == pytest.approx(want_total, rel=RTOL)
    for k in ("loss", "aux_loss", "total_loss"):
        assert metrics[k] == pytest.approx(want_m[k], rel=RTOL, abs=ATOL), k
    if arch == "deepseek-v3-671b":
        assert metrics["aux_loss"] > 0
    want = list(iter_leaves(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_grads), device="cpu")))
    assert len(want) == len(grads)
    scale = max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=f"leaf {i}")
    if case == "glu-kernel":
        # FP, BP and WG of each layer's down-projection through the gated
        # GEMM; the masked tail's error tiles are gated off in BP.
        assert len(gated) == 3 * cfg.num_layers
        assert sum(n for _, n in gated) > 0
    else:
        assert gated == []


@pytest.mark.parametrize("act", ["relu", "relu2"])
def test_relu_kernel_mode_is_not_differentiable_in_either_package(act):
    """The relu-bitmap kernel has no reverse rule in the reference; the
    port refuses the backward through it too, on any device."""
    sp = dict(enabled=True, mode="kernel", **SMALL)
    ref_cfg, cfg = _configs("smollm-135m", mlp_act=act, sparsity=sp)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    with pytest.raises(ValueError):
        _ref_value_and_grad(ref_cfg, ref_params, batch)
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    with pytest.raises(ValueError, match="not differentiable"):
        _port_value_and_grad(cfg, params, batch)
    # The forward alone (serving) still runs the kernel.
    with torch.no_grad():
        model_lib.loss_fn(params, cfg,
                          {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(remat):
    """Activation checkpointing changes no value: loss and every gradient
    equal the run without it, bit for bit (also through the hybrid's
    shared block and the SparCE ops' autograd rules)."""
    for arch, sp in (("smollm-135m", dict(enabled=True, mode="kernel",
                                          **SMALL)),
                     ("zamba2-7b", None)):
        ref_cfg = ref_get_config(arch).reduced()
        np_params = jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(2)))
        fields = {} if sp is None else {"sparsity": sp}
        out = []
        for mode in ("none", remat):
            _, cfg = _configs(arch, remat=mode, **fields)
            params = params_from_reference(np_params, device="cpu")
            out.append(_port_value_and_grad(cfg, params, _batch(cfg)))
        assert out[0][0] == out[1][0]
        for a, b in zip(out[0][2], out[1][2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ AdamW
def _tree(seed):
    """A small f32 numpy tree: a matrix, and a list of layer dicts with a
    matrix and a vector (no weight decay)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": [{"a": rng.standard_normal((8, 4)).astype(np.float32),
                        "b": rng.standard_normal((4,)).astype(np.float32)}
                       for _ in range(2)]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_matches_reference(dtype, clip):
    """Five updates with a cosine schedule: params (bf16 rounded to
    nearest even like the reference's cast), moments, grad norm and lr."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                        _tree(0))
    sched_ref = ref_adamw.cosine_schedule(1e-2, 2, 5)
    sched = adamw.cosine_schedule(1e-2, 2, 5)
    ref_opt = ref_adamw.AdamW(lr=sched_ref, clip_norm=clip)
    opt = adamw.AdamW(lr=sched, clip_norm=clip)
    params = jax.tree_util.tree_map(
        lambda a: to_tensor(np.asarray(a), "cpu"), ref_params)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for s in range(5):
        np_grads = _tree(10 + s)
        ref_params, ref_state, ref_stats = ref_opt.update(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), np_grads),
            ref_state, ref_params)
        params, state, stats = opt.update(
            jax.tree_util.tree_map(
                lambda a: to_tensor(np.asarray(jnp.asarray(a, jdt)), "cpu"),
                np_grads), state, params)
        assert float(stats["grad_norm"]) == pytest.approx(
            float(ref_stats["grad_norm"]), rel=1e-6)
        assert float(stats["lr"]) == pytest.approx(float(ref_stats["lr"]),
                                                   rel=1e-6)
    assert int(state.step) == int(ref_state.step) == 5
    for ref_t, t in ((ref_params, params), (ref_state.mu, state.mu),
                     (ref_state.nu, state.nu)):
        want = list(iter_leaves(jax.tree_util.tree_map(
            lambda a: to_tensor(np.asarray(a), "cpu"), ref_t)))
        got = list(iter_leaves(t))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-6,
                                       atol=1e-7)


def test_schedule_and_global_norm_match_reference():
    for args in ((3e-4, 100, 1000), (1e-3, 0, 10), (2e-3, 5, 5)):
        ref_lr, lr = ref_adamw.cosine_schedule(*args), \
            adamw.cosine_schedule(*args)
        for s in (0, 1, 3, 5, 50, 99, 100, 101, 500, 999, 1000, 2000):
            assert lr(s) == pytest.approx(
                float(ref_lr(jnp.asarray(s, jnp.int32))), rel=1e-6), (args, s)
    t = _tree(3)
    want = float(ref_adamw.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                              t)))
    got = float(adamw.global_norm(jax.tree_util.tree_map(torch.from_numpy,
                                                         t)))
    assert got == pytest.approx(want, rel=1e-6)


def test_bf16_update_rounds_to_nearest_even():
    """(p - lr * delta) in f32, then cast: ties go to the even mantissa,
    as the reference's cast does."""
    p = jnp.asarray(np.linspace(-3, 3, 64, dtype=np.float32), jnp.bfloat16)
    g = jnp.asarray(np.linspace(1, -1, 64, dtype=np.float32), jnp.bfloat16)
    ref_opt, opt = ref_adamw.AdamW(lr=0.37, weight_decay=0.3), \
        adamw.AdamW(lr=0.37, weight_decay=0.3)
    want, _, _ = ref_opt.update({"p": g[None]}, ref_opt.init({"p": p[None]}),
                                {"p": p[None]})
    tp = to_tensor(np.asarray(p[None]), "cpu")
    got, _, _ = opt.update({"p": to_tensor(np.asarray(g[None]), "cpu")},
                           opt.init({"p": tp}), {"p": tp})
    np.testing.assert_array_equal(
        got["p"].view(torch.int16).numpy(),
        np.asarray(want["p"]).view(np.int16))


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["smollm-135m", "musicgen-large",
                                  "pixtral-12b"])
def test_batches_equal_reference_exactly(arch):
    ref_cfg, cfg = _configs(arch)
    shape = (24 if arch == "pixtral-12b" else 16, 6)
    ref_it = ref_pipeline.make_batch_iterator(
        ref_cfg, RefShapeConfig("t", *shape, "train"),
        ref_pipeline.DataConfig(seed=5, noise=0.2), start_step=3, host_id=1,
        n_hosts=2)
    it = pipeline.make_batch_iterator(
        cfg, ShapeConfig("t", *shape, "train"),
        pipeline.DataConfig(seed=5, noise=0.2), start_step=3, host_id=1,
        n_hosts=2)
    for _ in range(3):
        want, got = next(ref_it), next(it)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    specs = pipeline.input_specs(cfg, ShapeConfig("t", 32, 4, "train"))
    ref_specs = ref_pipeline.input_specs(
        ref_cfg, RefShapeConfig("t", 32, 4, "train"))
    assert {k: v[0] for k, v in specs.items()} == {
        k: v.shape for k, v in ref_specs.items()}
    assert specs["tokens"][1] == torch.int32


def test_file_corpus_and_host_slice_equal_reference(tmp_path):
    path = str(tmp_path / "toks.npy")
    np.save(path, np.arange(1000, dtype=np.int32) % 97)
    for step in (0, 7):
        np.testing.assert_array_equal(
            pipeline.FileCorpus(path, 97).batch(step, 4, 12),
            ref_pipeline.FileCorpus(path, 97).batch(step, 4, 12))
    for args in ((8, 0, 2), (8, 1, 2), (9, 2, 3)):
        assert pipeline.host_slice(*args) == ref_pipeline.host_slice(*args)


# ------------------------------------------------------------- checkpoint
def _ck_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((32, 16), generator=g),
            "nested": {"b": torch.randn((16,), generator=g).to(
                torch.bfloat16)},
            "layers": [torch.randn((3,), generator=g)],
            "step_count": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_layout(tmp_path):
    t = _ck_tree(0)
    ckpt.save(str(tmp_path), 10, t)
    restored, step, meta = ckpt.restore(str(tmp_path), t)
    assert step == 10 and meta["step"] == 10
    for a, b in zip(iter_leaves(t), iter_leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The reference's layout: leaf_i arrays (bf16 as f32), LATEST last.
    d = tmp_path / "step_00000010"
    assert sorted(os.listdir(d)) == ["arrays.npz", "meta.json"]
    assert (tmp_path / "LATEST").read_text() == "step_00000010"
    with np.load(d / "arrays.npz") as data:
        assert sorted(data.files) == [f"leaf_{i}" for i in range(4)]
        assert data["leaf_1"].dtype == np.float32  # the bf16 leaf
    # The reference's manager reads it back into a tree of its own.
    like = jax.tree_util.tree_map(
        lambda x: jnp.zeros(tuple(x.shape), {
            torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}.get(
                x.dtype, jnp.float32)), t)
    ref_tree, ref_step, _ = ref_ckpt.restore(str(tmp_path), like)
    assert ref_step == 10
    np.testing.assert_array_equal(np.asarray(ref_tree["w"]), t["w"].numpy())


def test_checkpoint_latest_pointer_and_cleanup(tmp_path):
    t = _ck_tree(1)
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.cleanup(str(tmp_path), keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    _, step, _ = ckpt.restore(str(tmp_path), t)
    assert step == 4
    os.remove(tmp_path / "LATEST")  # an interrupted pointer write
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_checkpoint_interrupted_save_is_invisible(tmp_path):
    t = _ck_tree(2)
    ckpt.save(str(tmp_path), 5, t)
    os.makedirs(tmp_path / "step_00000006.tmp")
    (tmp_path / "step_00000006.tmp" / "partial").write_text("garbage")
    _, step, _ = ckpt.restore(str(tmp_path), t)
    assert step == 5


def test_checkpoint_async_save(tmp_path):
    t = _ck_tree(3)
    th = ckpt.save(str(tmp_path), 42, t, async_=True)
    assert isinstance(th, threading.Thread)
    th.join(timeout=30)
    assert not th.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 42


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), {"a": torch.zeros(2)})


# ---------------------------------------------------------------- Trainer
SHAPE = ShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")
REF_SHAPE = RefShapeConfig("tiny", seq_len=32, global_batch=8, kind="train")


def _bridged_init(monkeypatch):
    """The port's trainer starts from the reference's weights for its
    config (the reference's init_params at PRNGKey(seed), bridged)."""
    def init(cfg, seed=0, device="cuda"):
        ref_cfg = ref_get_config(cfg.name).reduced()
        ref_cfg = dataclasses.replace(ref_cfg, **{
            f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg) if f.name != "sparsity"})
        if cfg.sparsity is not None:
            ref_cfg = dataclasses.replace(ref_cfg, sparsity=RefSparsityConfig(
                **dataclasses.asdict(cfg.sparsity)))
        ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
        return params_from_reference(
            jax.tree_util.tree_map(np.asarray, ref_params), device=device)
    monkeypatch.setattr(port_trainer.model_lib, "init_params", init)


def _quickstart_cfgs():
    fields = dict(mlp_act="relu")
    sp = dict(enabled=True, mode="reference")
    return (dataclasses.replace(ref_get_config("smollm-135m").reduced(),
                                sparsity=RefSparsityConfig(**sp), **fields),
            dataclasses.replace(get_config("smollm-135m").reduced(),
                                sparsity=SparsityConfig(**sp), **fields))


@pytest.fixture(scope="module")
def quickstart_reference():
    """Part 2 of examples/quickstart.py through the reference: a tiny
    relu LM with SparCE-gated MLPs, 30 steps."""
    ref_cfg, _ = _quickstart_cfgs()
    tr = ref_trainer.Trainer(ref_cfg, REF_SHAPE,
                             ref_adamw.AdamW(lr=3e-3, weight_decay=0.0),
                             ref_trainer.TrainConfig(steps=30, log_every=1))
    out = tr.run(ref_pipeline.make_batch_iterator(
        ref_cfg, REF_SHAPE, ref_pipeline.DataConfig(noise=0.05)))
    return [h["loss"] for h in out["history"] if "loss" in h]


def _port_quickstart(tmp_path=None, steps=30, **kw):
    _, cfg = _quickstart_cfgs()
    tc = port_trainer.TrainConfig(
        steps=steps, log_every=1, ckpt_every=10,
        ckpt_dir=str(tmp_path) if tmp_path else None, async_ckpt=False, **kw)
    tr = port_trainer.Trainer(cfg, SHAPE, adamw.AdamW(lr=3e-3,
                                                      weight_decay=0.0),
                              tc, device="cpu")
    return cfg, tr


def test_quickstart_history_matches_reference(quickstart_reference,
                                              monkeypatch):
    """The 30-step loss history equals the reference's within f32
    tolerance and falls, as the quickstart asserts."""
    _bridged_init(monkeypatch)
    cfg, tr = _port_quickstart()
    out = tr.run(pipeline.make_batch_iterator(
        cfg, SHAPE, pipeline.DataConfig(noise=0.05)))
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert len(losses) == len(quickstart_reference) == 30
    np.testing.assert_allclose(losses, quickstart_reference, rtol=1e-3)
    assert losses[-1] < losses[0]
    assert out["final_step"] == 30


def test_fault_recovery_replays_the_uninterrupted_history(
        quickstart_reference, tmp_path, monkeypatch):
    """A step that raises RuntimeError restores the last checkpoint and
    goes on from it. With data keyed by step (the restart re-reads from
    the restored step, as a restarted job's iterator would), the losses
    after the restart equal an uninterrupted run's (the reference's)."""
    _bridged_init(monkeypatch)
    cfg, tr = _port_quickstart(tmp_path, steps=30)
    it = pipeline.make_batch_iterator(cfg, SHAPE,
                                      pipeline.DataConfig(noise=0.05))

    class Rewindable:
        def __init__(self, batches):
            self.batches, self.pos = batches, 0

        def __next__(self):
            self.pos += 1
            return self.batches[self.pos - 1]

    data = Rewindable([next(it) for _ in range(30)])
    crashed = []

    def fault(step):
        if step == 15 and not crashed:
            crashed.append(step)
            data.pos = ckpt.latest_step(str(tmp_path))
            raise RuntimeError("simulated preemption")

    out = tr.run(data, fault_hook=fault)
    events = [h for h in out["history"] if h.get("event") == "restart"]
    assert len(events) == 1 and out["final_step"] == 30
    assert data.pos == 30
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    # Steps 0-14, then 10-29 again after the restore from step 10.
    assert len(losses) == 15 + 20
    np.testing.assert_allclose(losses[:15], quickstart_reference[:15],
                               rtol=1e-3)
    np.testing.assert_allclose(losses[15:], quickstart_reference[10:],
                               rtol=1e-3)


def test_step_failure_without_checkpoints_reraises(monkeypatch):
    _bridged_init(monkeypatch)
    cfg, tr = _port_quickstart(steps=3)

    def fault(step):
        raise RuntimeError("lost device")
    with pytest.raises(RuntimeError, match="lost device"):
        tr.run(pipeline.make_batch_iterator(cfg, SHAPE,
                                            pipeline.DataConfig()),
               fault_hook=fault)


def test_straggler_detection_and_resume(tmp_path, monkeypatch):
    import time
    _bridged_init(monkeypatch)
    cfg, tr = _port_quickstart(tmp_path, steps=10)

    def slow(step):
        if step == 8:
            time.sleep(1.5)  # a simulated slow host
    out = tr.run(pipeline.make_batch_iterator(cfg, SHAPE,
                                              pipeline.DataConfig()),
                 fault_hook=slow)
    assert any(e["step"] == 8 for e in out["straggler_events"])
    assert ckpt.latest_step(str(tmp_path)) == 10
    # A new trainer in the same directory resumes at 10, finishes at 12.
    cfg2, tr2 = _port_quickstart(tmp_path, steps=12)
    out2 = tr2.run(pipeline.make_batch_iterator(
        cfg2, SHAPE, pipeline.DataConfig(), start_step=10))
    assert out2["final_step"] == 12
    assert [h["step"] for h in out2["history"]] == [10, 11]


def test_mesh_and_zero1_are_refused():
    """Nothing is refused any more: a mesh is accepted (it trains on
    spawned ranks, tests/test_torch_train_mesh*.py) and ``zero1`` on one
    host trains as without it, as in the reference, whose ZeRO-1 rule
    only shards over a mesh's 'data' axis."""
    from repro_torch.parallel.sharding import Mesh
    _, cfg = _quickstart_cfgs()
    tr = port_trainer.Trainer(cfg, SHAPE, adamw.AdamW(),
                              port_trainer.TrainConfig(), device="cpu",
                              mesh=Mesh({"data": 1, "model": 1}))
    assert tr.mesh is not None and tr.step_fn is None
    hist = []
    for zero1 in (False, True):
        tr = port_trainer.Trainer(cfg, SHAPE, adamw.AdamW(),
                                  port_trainer.TrainConfig(steps=2,
                                                           log_every=1,
                                                           zero1=zero1),
                                  device="cpu")
        out = tr.run(pipeline.make_batch_iterator(cfg, SHAPE,
                                                  pipeline.DataConfig()))
        hist.append([h["loss"] for h in out["history"]])
    assert hist[0] == hist[1]


def test_train_launcher_matches_reference_launcher(capsys, monkeypatch):
    """Same flags, the reference's weights through the bridge: the same
    step lines (loss, grad norm, lr) within f32 rounding."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train as port_train
    _bridged_init(monkeypatch)
    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "4",
            "--seq-len", "16", "--global-batch", "2", "--log-every", "1",
            "--warmup", "2", "--lr", "1e-3"]
    ref_train.main(argv)
    ref_lines = capsys.readouterr().out.splitlines()
    port_train.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(ref_lines) == 5
    assert lines[-1] == ref_lines[-1]

    def nums(ln):
        return [float(t) for t in ln.split()[1::2]]
    for a, b in zip(lines[:-1], ref_lines[:-1]):
        np.testing.assert_allclose(nums(a), nums(b), rtol=1e-3)
    # --mesh no longer raises: one rank over gloo prints the lines of
    # the port's own single host (the spawned rank draws the port's
    # weights, not the bridged ones).
    monkeypatch.undo()
    want = port_train.main(argv + ["--device", "cpu"])["history"]
    capsys.readouterr()
    got = port_train.main(argv + ["--mesh", "1,1", "--device", "cpu"])
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want], rtol=1e-6)
