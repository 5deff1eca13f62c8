"""``parallel/pipeline.py:pipeline_forward`` (GPipe over the ``pod``
axis) on gloo meshes of CPU ranks, against the reference's
``pipeline_forward`` on conftest's 8 host devices.

The reference test's case (``tests/test_distributed.py``): stages
``tanh(h @ w)`` with (n_stages, 16, 16) weights at 0.3 scale, x (8, 16),
drawn here with numpy. Forward on ("pod",) (2), ("pod", "data") (2, 2),
(1,) and (4,), n_micro 2 and 4, at the reference test's rtol = atol =
1e-5; the gradients of sum(y * cot) with respect to x (on the stage-0
ranks, the only ones that read x) and to each rank's stage slice against
``jax.grad`` of the sequential composition at rtol 1e-5, atol 1e-6. The
schedule's counts: ``stage_fn`` runs n_micro + n_stages - 1 times on
every rank; the forward's collective-permute bytes are that many
micro-batches, its all-gather the outputs once; a trace mesh counts the
same. A ring that sends to s - 1 fails the forward check.

One spawn per mesh runs every scenario; every process group has a
timeout and every spawn a deadline.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import mesh as ref_mesh_lib
from repro.parallel.pipeline import pipeline_forward as ref_pipeline_forward
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import sharding as shd
import torch_pipeline_scenarios as ps

TIMEOUT_S = 30.0  # every process group's
DEADLINE_S = 120.0  # every spawn's
FWD_TOL = 1e-5  # the reference test's rtol and atol
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
MESHES = {"2": (2,), "2x2": (2, 2), "1": (1,), "4": (4,)}
N_MICRO = (2, 4)


def _axes(shape):
    return ("pod", "data")[:len(shape)]


def _specs(shape):
    n = shape[0]
    out = []
    for n_micro in N_MICRO:
        W, x, cot = ps.numpy_case(n)
        out.append(dict(W=W, x=x, cot=cot, n_micro=n_micro))
    if shape == (4,):  # the mutant needs a ring where s - 1 != s + 1
        W, x, cot = ps.numpy_case(4)
        out.append(dict(W=W, x=x, cot=cot, n_micro=4, mutant=True))
    if shape == (2, 2):  # micro-batches cut over 'data'
        W, x, cot = ps.numpy_case(2)
        out.append(dict(W=W, x=x, cot=cot, n_micro=2,
                        extra_specs=(None, "data")))
    return out


@functools.lru_cache(maxsize=None)
def _run(name):
    shape = MESHES[name]
    specs = _specs(shape)
    outs = mesh_lib.spawn_mesh(ps.pipeline_rank, shape, (specs,),
                               axes=_axes(shape), timeout_s=TIMEOUT_S,
                               deadline_s=DEADLINE_S)
    return specs, outs


def _reference(W, x, cot, n_micro):
    """The reference's pipeline_forward on a (n, 8 / n) ("pod", "data")
    jax mesh, and jax.grad of the sequential composition."""
    n = W.shape[0]
    mesh = ref_mesh_lib.make_mesh((n, 8 // n), ("pod", "data"))

    def stage_fn(w, h):
        return jnp.tanh(h @ w)

    y = ref_pipeline_forward(stage_fn, jnp.asarray(W), jnp.asarray(x), mesh,
                             axis="pod", n_micro=n_micro)

    def seq(W, x):
        h = x
        for s in range(n):
            h = stage_fn(W[s], h)
        return jnp.sum(h * cot)

    gW, gx = jax.grad(seq, argnums=(0, 1))(jnp.asarray(W), jnp.asarray(x))
    return np.asarray(y), np.asarray(gW), np.asarray(gx)


@pytest.mark.parametrize("n_micro", N_MICRO)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_pipeline_matches_reference(cpu_mesh, name, n_micro):
    specs, outs = _run(name)
    i = N_MICRO.index(n_micro)
    spec = specs[i]
    y, gW, gx = _reference(spec["W"], spec["x"], spec["cot"], n_micro)
    for r, rank in enumerate(outs):
        got = rank[i]
        np.testing.assert_allclose(got["y"], y, rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(got["y_grad_run"], y, rtol=FWD_TOL,
                                   atol=FWD_TOL)
        s = got["stage"]
        np.testing.assert_allclose(got["w_grad"], gW[s], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{name} W[{s}]")
        assert got["w_grad_others"] == 0.0  # only its stage's slice
        if s == 0:
            np.testing.assert_allclose(got["x_grad"], gx, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)
        else:
            assert not np.any(got["x_grad"]), (name, r)


@pytest.mark.parametrize("n_micro", N_MICRO)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_schedule_counts(name, n_micro):
    """Every rank runs the stage n_micro + n_stages - 1 times on one
    micro-batch; the forward permutes one micro-batch a step and gathers
    the outputs once (nothing on one stage); a trace mesh counts the
    same calls and bytes."""
    specs, outs = _run(name)
    i = N_MICRO.index(n_micro)
    spec = specs[i]
    n = spec["W"].shape[0]
    steps = n_micro + n - 1
    B, d = spec["x"].shape
    micro = (B // n_micro) * d * 4
    for rank in outs:
        got = rank[i]
        assert got["calls"] == [(B // n_micro, d)] * steps
        st = got["stats"]
        if n == 1:
            assert st["total"] == 0 and not any(st["counts"].values())
            continue
        assert st["counts"]["collective-permute"] == steps
        assert st["collective-permute"] == steps * micro
        assert st["counts"]["all-gather"] == 1
        assert st["all-gather"] == B * d * 4
        assert st["total"] == steps * micro + B * d * 4
    traced = ps.trace_counts(spec)
    assert traced["shape"] == (B, d)
    want = outs[0][i]["stats"]
    for key in ("total", "counts", "collective-permute", "all-gather"):
        assert traced["stats"][key] == want[key], key


def test_mutant_ring_fails_the_reference_check(cpu_mesh):
    """A ring that hands stage s's output to s - 1 (on 4 stages, not the
    same ring) must fail the forward check the real ring passes."""
    specs, outs = _run("4")
    spec = specs[-1]
    assert spec["mutant"]
    y, _, _ = _reference(spec["W"], spec["x"], spec["cot"], spec["n_micro"])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(outs[0][-1]["y"], y, rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_extra_specs_cut_the_micro_batches(cpu_mesh):
    """With ``extra_specs`` (None, "data") each (pod, data) rank runs its
    'data' block of every micro-batch and returns those rows of y."""
    specs, outs = _run("2x2")
    spec = specs[-1]
    y, _, _ = _reference(spec["W"], spec["x"], spec["cot"], spec["n_micro"])
    n_micro = spec["n_micro"]
    B, d = spec["x"].shape
    mesh = shd.Mesh({"pod": 2, "data": 2})
    for r, rank in enumerate(outs):
        want = shd.shard_of(
            torch.from_numpy(np.array(y)).reshape(n_micro, B // n_micro, d),
            (None, "data"), mesh, r).reshape(-1, d).numpy()
        np.testing.assert_allclose(rank[-1]["y"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"rank {r}")
