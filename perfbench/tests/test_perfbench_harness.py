"""The harness's own checks on the CPU: each cell rehearsed at reduced
sizes end to end, the seeded traffic, the modules a run loads, a run
without a card, and faults planted under the timed path, each of which
has to turn ``correct`` false."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import rehearse  # noqa: E402

from perfbench import harness, loadgen  # noqa: E402
from perfbench.traffic import train_steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_prints_a_contract_line(name):
    out = rehearse.rehearse(name, seed=2 ** 33 + 5, seconds=1.5)
    res = out["result"]
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_metric_readers_read_the_rehearsal(name):
    """Every end-to-end metric of the cell is read from a rehearsal's
    context (the numbers are the CPU's, never reported)."""
    from perfbench import run
    cell = rehearse.small_cell(name)
    out = rehearse.rehearse(name, seed=3, seconds=1.5, cell=cell)
    got = run.read_metrics(cell, "end_to_end", out["ctx"])
    assert set(got) == {m["name"] for m in cell.metrics("end_to_end")}
    assert all(v["value"] > 0 for v in got.values())


def test_every_metric_and_cell_has_its_files():
    pkg = ROOT / "perfbench"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"])), m["name"]
    for w in BENCH["workloads"]:
        wl = json.loads((pkg / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert (pkg / "traffic" / f"{w['traffic']}.py").exists()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def _strata(p, key_min, key_max, values, log):
    """Stratum (0..block-1) of each value under the law's quantiles."""
    lo, hi = p[key_min], p[key_max]
    if log:
        lo, hi, values = np.log(lo), np.log(hi), np.log(values)
    u = (np.asarray(values, float) - lo) / (hi - lo)
    return list(np.minimum((u * p["block"]).astype(int), p["block"] - 1))


@pytest.mark.parametrize("cell", ["nemo12b.rag.batch", "nemo12b.rag.open"])
def test_sizes_are_seeded_and_the_same_work_for_every_seed(cell):
    """Each pass holds every grid pair once, for every seed; each block
    holds one prompt and one budget of every stratum of the laws."""
    p = rehearse.harness.load_cell(cell).workload["params"]
    n, whole = p["block"], p["block"] * p["fine"]

    def take(seed, k):
        it = loadgen.sizes(p, seed)
        return [next(it) for _ in range(k)]

    a, b, c = take(7, 2 * whole), take(7, 2 * whole), take(2 ** 40 + 1,
                                                            2 * whole)
    assert a == b and a != c
    grid = sorted(x for row in loadgen.size_grid(p) for x in row)
    assert len(set(grid)) == whole
    for k in range(2):
        part = slice(k * whole, (k + 1) * whole)
        assert sorted(a[part]) == sorted(c[part]) == grid
    for k in range(2 * whole // n):
        blk = a[k * n:(k + 1) * n]
        assert sorted(_strata(p, "prompt_min", "prompt_max",
                              [x for x, _ in blk], True)) == list(range(n))
        assert sorted(_strata(p, "new_min", "new_max",
                              [y for _, y in blk], False)) == list(range(n))
    prompts = [x for x, _ in a]
    assert min(prompts) >= p["prompt_min"] and max(prompts) <= p["prompt_max"]


def test_first_fill_takes_the_steady_remaining_budgets():
    """The remaining budgets of the requests in service: the same for
    every seed in another order, from 1 to the largest budget, with the
    mean a steady state has, E[B^2 + B] / (2 E[B]) over the grid."""
    p = rehearse.harness.load_cell("nemo12b.rag.batch").workload["params"]
    a = loadgen.residual_budgets(p, 48, 5)
    b = loadgen.residual_budgets(p, 48, 2 ** 40 + 9)
    assert a != b and sorted(a) == sorted(b)
    budgets = np.array([y for row in loadgen.size_grid(p) for _, y in row])
    assert 1 <= min(a) and max(a) <= budgets.max()
    want = (budgets ** 2 + budgets).mean() / (2 * budgets.mean())
    assert np.mean(a) == pytest.approx(want, rel=0.03)


def test_arrivals_are_seeded_and_the_same_for_every_seed():
    from perfbench.traffic import open_loop
    p = rehearse.harness.load_cell("nemo12b.rag.open").workload["params"]
    n, whole = int(p["gap_block"]), int(p["gap_block"] * p["gap_fine"])

    def take(seed):
        it = open_loop.gaps(p, seed)
        return [next(it) for _ in range(2 * whole)]

    a, b, c = take(7), take(7), take(2 ** 40 + 3)
    assert a == b and a != c
    assert sorted(a[:whole]) == sorted(c[:whole]) == sorted(a[whole:])
    assert len(set(a[:whole])) == whole
    assert sum(a[:whole]) == pytest.approx(whole / p["rate"])
    # A block of gap_block gaps holds one of each stratum of the law.
    ranked = {g: i // p["gap_fine"] for i, g in enumerate(sorted(a[:whole]))}
    for k in range(whole // n):
        assert sorted(ranked[g] for g in a[k * n:(k + 1) * n]) == \
            list(range(n))


def test_shared_readers_read_a_window():
    """The metrics that name a shared reader read a context made by hand
    (a window of two stretches around one profiled slice)."""
    snaps = [("open", 0.0, {"decode_s": 0.0, "ticks": 0.0, "prefill_s": 0.0,
                            "prefill_tokens": 0.0}),
             ("slice_start.0", 4.0, {"decode_s": 1.0, "ticks": 10.0,
                                     "prefill_s": 2.0,
                                     "prefill_tokens": 4000.0}),
             ("slice_end.0", 6.0, {"decode_s": 3.0, "ticks": 11.0,
                                   "prefill_s": 2.0,
                                   "prefill_tokens": 4000.0}),
             ("close", 10.0, {"decode_s": 4.0, "ticks": 20.0,
                              "prefill_s": 3.0, "prefill_tokens": 6000.0})]
    ctx = {"snaps": snaps, "t_open": 0.0, "t_close": 10.0,
           "peak_window_bytes": 2 ** 31,
           "trace": harness.TraceReading(2.0, 1.5, 3, {}, [], [])}
    from perfbench import readers
    assert readers.intervals(ctx) == [(0.0, 4.0), (6.0, 10.0)]
    got = {m["name"]: harness.metric_reader(m["name"])(ctx)
           for m in BENCH["per_layer"]
           if (ROOT / "perfbench" / "metrics" / f"{m['name']}.json").exists()
           and "roofline" not in m["name"]}
    assert got["engine.tick_ms.batch"] == pytest.approx(1e3 * 2.0 / 19)
    assert got["engine.prefill_ms_per_ktok.open"] == pytest.approx(
        1e3 * 3.0 / 6.0)
    assert got["device.idle_share.train"] == pytest.approx(25.0)
    assert got["device.peak_mem_gib.batch"] == 2.0
    assert harness.metric_reader("paged_gqa_roofline.batch")(ctx) is None


def test_rows_are_seeded():
    c1, c2 = train_steps.Corpus(256, 5, 0.1), train_steps.Corpus(256, 6, 0.1)
    assert np.array_equal(c1.batch(0, 2, 16), c1.batch(0, 2, 16))
    assert not np.array_equal(c1.batch(0, 2, 16), c1.batch(1, 2, 16))
    assert not np.array_equal(c1.batch(0, 2, 16), c2.batch(0, 2, 16))
    r = loadgen.Record(4, 10, 3, seed=9, vocab=256)
    assert np.array_equal(r.prompt(), r.prompt())


def test_a_run_loads_no_jax_and_no_reference_package():
    """Every module a rehearsed run loads, by whole top-level name."""
    code = (
        "import sys; sys.path.insert(0, 'perfbench/tests');"
        "import torch; torch.set_num_threads(1); import rehearse;"
        "[rehearse.rehearse(n, seed=1, seconds=0.5) for n in %r];"
        "from perfbench import harness;"
        "print('FORBIDDEN', harness.forbidden_modules());"
        "print('PORT', 'repro_torch' in sys.modules)" % CELLS)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout and "PORT True" in out.stdout


def test_forbidden_names_are_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.x"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_without_a_card_the_run_prints_nothing_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "nemo12b.rag.batch", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# --------------------------------------------------------------- faults
SERVE_CELLS = [w["name"] for w in BENCH["workloads"]
               if w["traffic"] in ("closed_loop", "open_loop")]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_fault_token_altered_where_produced(name):
    """Every third decode tick the engine's sampler puts out, for every
    slot, the token the logits rank last: the served tokens no longer
    match the reference's best."""
    from repro_torch.runtime import server as srv_mod
    orig = srv_mod.Server._sample
    ticks = [0]

    def bad(self, logits):
        out = orig(self, logits)
        if out.ndim == 1 and out.shape[0] > 1:
            ticks[0] += 1
            if ticks[0] % 3 == 0:
                out = np.argmin(logits, axis=-1)
        return out

    srv_mod.Server._sample = bad
    try:
        out = rehearse.rehearse(name, seed=4, seconds=1.5)
    finally:
        srv_mod.Server._sample = orig
    assert out["result"]["correct"] is False


def _train_fault(patch):
    from repro_torch.runtime import trainer as tr_mod
    saved = {k: getattr(tr_mod.Trainer, k) for k in patch}
    for k, v in patch.items():
        setattr(tr_mod.Trainer, k, v)
    try:
        return rehearse.rehearse("smollm135m.train.s2048", seed=8,
                                 seconds=1.0)
    finally:
        for k, v in saved.items():
            setattr(tr_mod.Trainer, k, v)


def test_fault_step_returns_its_state_unchanged():
    from repro_torch.runtime import trainer as tr_mod
    orig = tr_mod.Trainer.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        step = self.step_fn

        def same(params, state, batch):
            _, _, m = step(params, state, batch)
            return params, state, m
        self.step_fn = same

    out = _train_fault({"__init__": init})
    assert out["result"]["correct"] is False
    assert out["checks"]["change_norm_gap"]["value"] >= 0.99


def test_fault_half_the_batch_left_out():
    from repro_torch.runtime import trainer as tr_mod
    orig = tr_mod.Trainer.to_device

    def half(self, batch):
        b = orig(self, batch)
        return {k: v[: v.shape[0] // 2] for k, v in b.items()}

    out = _train_fault({"to_device": half})
    assert out["result"]["correct"] is False
