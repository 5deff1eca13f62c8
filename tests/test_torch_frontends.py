"""The vlm (``pixtral-12b``) and audio (``musicgen-large``) frontends in
the port against the reference, on the CPU.

Same reduced configs, same weights (carried over by the bridge):
the forward's logits and caches (patch rows prepended; four codebook
streams summed at the embedding, four f32 heads), then the engines --
drain-mode ``generate`` on the paged pool (the paged GQA kernel's and
the fused GLU kernel's plain versions) and on contiguous caches,
``serve_trace`` under the SLO with preemption, the prefix cache for the
audio frontend and its refusal for the vlm one, and the launcher --
must give the reference's tokens, schedules and every integer metric.
Helpers: ``test_torch_live_engine.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as ref_model
from repro.runtime import server as ref_server
from repro_torch.models import model as model_lib
from repro_torch.runtime import server as port_server
from serving_harness import (
    OpenLoopTraffic, Traffic, make_open_loop_trace, make_traffic,
)
from test_torch_live_engine import (  # noqa: F401 - fixture
    assert_same_run, model, one_torch_thread, serve_configs,
    serve_trace_both,
)
from test_torch_server import (
    _assert_engines_equal, _bridge_launcher_weights, _launch_lines,
)

ARCHS = ("pixtral-12b", "musicgen-large")
GLU_FUSED = dict(enabled=True, mode="fused", gate_threshold=0.0,
                 autotune=False)


@pytest.fixture(scope="module", params=ARCHS)
def frontend(request):
    return model(request.param)


def _batch(cfg, rng, B, S):
    """A seeded prefill batch: (B, S) tokens (audio (B, K, S)) and, for
    the vlm, (B, P, d) patch embeddings."""
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B,) + lead + (S,)).astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def test_forward_prefill_and_decode_match_reference(frontend):
    """Logits of the full forward, of a prefill into caches (patch rows
    counted in the lengths) and of a decode step after it; the codes
    logits are (B, S, K, V)."""
    ref_cfg, cfg, ref_params, params = frontend
    rng = np.random.default_rng(0)
    batch = _batch(ref_cfg, rng, 2, 6)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _, _ = ref_model.forward(ref_params, ref_cfg,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()})
    with torch.no_grad():
        got, _, _ = model_lib.forward(params, cfg, tb)
    rows = 6 + (cfg.num_patches if cfg.frontend == "patches" else 0)
    shape = ((2, rows, cfg.num_codebooks, cfg.vocab_size)
             if cfg.frontend == "codes" else (2, rows, cfg.vocab_size))
    assert tuple(got.shape) == shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    max_len = rows + 4
    want_l, ref_caches = ref_model.prefill(
        ref_params, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()},
        max_len, last_only=True)
    with torch.no_grad():
        got_l, caches = model_lib.prefill(params, cfg, tb, max_len,
                                          last_only=True)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-5, atol=1e-5)
    assert caches["stack"].length.tolist() == [[rows, rows]] * cfg.num_layers
    step = rng.integers(0, cfg.vocab_size, (2,) + (
        (cfg.num_codebooks,) if cfg.frontend == "codes" else ()) + (1,))
    want_d, _ = ref_model.decode_step(ref_params, ref_cfg,
                                      jnp.asarray(step, jnp.int32),
                                      ref_caches)
    with torch.no_grad():
        got_d, _ = model_lib.decode_step(params, cfg, torch.from_numpy(step),
                                         caches)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-5)


def _generate_both(m, traffic, **sc_kw):
    ref_cfg, cfg, ref_params, params = m
    reqs = make_traffic(ref_cfg, traffic)
    ref_sc, sc = serve_configs(**sc_kw)
    ref_srv = ref_server.Server(ref_cfg, ref_params, ref_sc)
    ref_done = ref_srv.generate(
        [dataclasses.replace(r, out=None, stats={}) for r in reqs])
    srv = port_server.Server(cfg, params, sc, device="cpu")
    done = srv.generate([port_server.Request(
        uid=r.uid, prompt=np.asarray(r.prompt), max_new=r.max_new,
        eos_id=r.eos_id) for r in reqs])
    return ref_srv, ref_done, srv, done


@pytest.mark.parametrize("case", [
    # The paged kernel's and the fused GLU kernel's plain versions.
    dict(attn_kernel="paged", sparsity=GLU_FUSED, kv_block_size=8),
    # Gumbel-max sampling over (B, V) / (B, K, V), the gather path.
    dict(attn_kernel="gather", temperature=0.8, seed=3, kv_block_size=4),
], ids=["paged-kernels", "sampled-gather"])
def test_generate_matches_reference(case, frontend):
    """Drain mode on the paged pool: tokens ((n,) or (n, K) each),
    admission and completion order, every exact metric; the pool
    drains. The vlm's 8 patch rows sit in every slot's blocks."""
    traffic = Traffic(n_requests=5, prompt_lens=(2, 12), max_new=(1, 8),
                      seed=4)
    out = _generate_both(frontend, traffic, batch_slots=3, max_len=32,
                         **case)
    _assert_engines_equal(*out)
    srv, done = out[2], out[3]
    cfg = frontend[1]
    for r in done:
        want = ((len(r.out), cfg.num_codebooks)
                if cfg.frontend == "codes" else (len(r.out),))
        assert np.asarray(r.out).shape == want


def test_contiguous_layout_matches_reference(frontend):
    """``kv_block_size=0``: one (max_len + patch rows)-row cache a slot."""
    traffic = Traffic(n_requests=4, prompt_lens=(2, 10), max_new=(1, 6),
                      seed=7)
    ref_srv, ref_done, srv, done = _generate_both(
        frontend, traffic, batch_slots=2, max_len=24, kv_block_size=0)
    assert [np.asarray(r.out).tolist() for r in done] == [
        np.asarray(r.out).tolist() for r in ref_done]
    assert list(srv.admitted_uids) == list(ref_srv.admitted_uids)
    for name in ("ticks", "decode_tokens", "prefill_tokens", "kv_paged"):
        assert getattr(srv.metrics, name) == getattr(ref_srv.metrics, name)
    rows = 24 + (frontend[1].num_patches
                 if frontend[1].frontend == "patches" else 0)
    assert srv._st.caches["stack"].k.shape[2] == rows


def _preempt_trace(cfg):
    """A long low-priority victim, then an urgent arrival with a tight
    TTFT deadline onto a 1-slot engine: admitting it needs an eviction;
    the victim restores from prompt ++ produced in its own layout."""
    rng = np.random.default_rng(0)
    lead = (cfg.num_codebooks,) if cfg.frontend == "codes" else ()
    victim = ref_server.Request(
        uid=0, prompt=rng.integers(0, cfg.vocab_size, lead + (6,)),
        max_new=16)
    urgent = ref_server.Request(
        uid=1, prompt=rng.integers(0, cfg.vocab_size, lead + (4,)),
        max_new=4)
    return [(0.0, victim), (3.0, urgent)], {1: 5.0}, {1: 6.0}


def test_serve_trace_with_preemption_matches_reference(frontend):
    """The SLO scheduler's admission, the eviction and the restore: the
    same schedule, tokens, metrics and pool as the reference's."""
    trace, prios, deadlines = _preempt_trace(frontend[0])
    out = serve_trace_both(
        frontend, trace, priorities=prios, deadlines=deadlines,
        batch_slots=1, max_len=48, kv_block_size=8, preempt=True,
        slo=dict(target_ttft_ticks=64.0, target_itl_ticks=2.0))
    assert_same_run(*out)
    assert out[3].metrics.preemptions >= 1


def test_open_loop_trace_matches_reference(frontend):
    """A seeded Poisson trace under the SLO, paged kernels' plain
    versions, EOS ids drawn per request."""
    trace = make_open_loop_trace(frontend[0], OpenLoopTraffic(
        n_requests=6, prompt_lens=(2, 10), max_new=(2, 6), seed=5,
        rate_per_tick=0.5, eos_prob=0.5))
    out = serve_trace_both(
        frontend, trace, batch_slots=2, max_len=32, kv_block_size=8,
        attn_kernel="paged", sparsity=GLU_FUSED,
        slo=dict(target_ttft_ticks=32.0, target_itl_ticks=3.0))
    assert_same_run(*out)


def test_prefix_cache_audio_matches_reference_and_vlm_is_refused():
    """Codes prompts behind a shared (K, 16) prefix hit the index (the
    chain keys cover every stream); patch rows are per-request, so the
    vlm refuses the prefix cache with the reference's message."""
    m = model("musicgen-large")
    cfg = m[0]
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab_size, (cfg.num_codebooks, 16))
    trace = []
    for uid in range(4):
        own = rng.integers(0, cfg.vocab_size, (cfg.num_codebooks,
                                               2 + 3 * uid))
        trace.append((float(uid), ref_server.Request(
            uid=uid, prompt=np.concatenate([shared, own], axis=-1),
            max_new=4)))
    out = serve_trace_both(m, trace, batch_slots=2, max_len=48,
                           kv_block_size=8, prefix_cache=True)
    assert_same_run(*out)
    assert out[3].metrics.prefix_hits >= 1
    vlm = model("pixtral-12b")[1]
    with pytest.raises(ValueError, match="not supported for family 'vlm'"):
        port_server.Server(vlm, None, port_server.ServeConfig(
            max_len=32, kv_block_size=8, prefix_cache=True), device="cpu")


def test_validate_wants_codebook_prompts():
    cfg = model("musicgen-large")[1]
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    srv = port_server.Server(cfg, params, port_server.ServeConfig(
        batch_slots=1, max_len=16), device="cpu")
    with pytest.raises(ValueError, match=r"\(K, S\) codebook ids"):
        srv.generate([port_server.Request(uid=0, prompt=np.arange(4),
                                          max_new=2)])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_matches_reference_launcher(arch, capsys, monkeypatch):
    """The port's launcher on the reduced config (the reference's
    weights through the bridge), audio with a shared (K, 8) prefix,
    prints the reference launcher's tokens and counters."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve
    _bridge_launcher_weights(monkeypatch)
    argv = ["--arch", arch, "--reduced", "--requests", "3",
            "--prompt-len", "8", "--max-new", "4", "--batch-slots", "2",
            "--max-len", "32", "--mixed"]
    if arch == "musicgen-large":
        argv += ["--prefix-cache", "--shared-prefix-len", "8"]
    ref_lines = _launch_lines(ref_serve.main, argv, capsys)
    port_lines = _launch_lines(port_serve.main, argv + ["--device", "cpu"],
                               capsys)

    def stable(lines):
        keep = []
        for ln in lines:
            if ln.lstrip().startswith("req "):
                keep.append(ln.split("out=")[1])
            elif "prefix cache:" in ln or "paged KV:" in ln:
                keep.append(ln.strip())
        return keep

    assert stable(port_lines) == stable(ref_lines) != []
