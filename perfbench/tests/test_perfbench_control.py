"""The checks' controls at a size a test run holds, on the CPU: the plain
reference put in the program's place one precision down (float8 e4m3
weight products: matrices and their inputs) has to come out not correct
against the limits of the configurations' files. The same controls at
the cells' own sizes run on the card (``perfbench/tools/control_*.py``);
their readings and the limits are in PERF.md."""
from __future__ import annotations

import copy

import pytest
import torch

from perfbench import harness, loadgen
from perfbench.reference import llama
from perfbench.systems import serve as serve_sys
from perfbench.systems import train as train_sys
from perfbench.traffic import train_steps

# Published widths cut to what a CPU test holds.
MID = {"hidden_size": 512, "intermediate_size": 1536,
       "num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 64,
       "num_hidden_layers": 8, "vocab_size": 16384}
SMALL = {"hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_hidden_layers": 2, "vocab_size": 256}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def sized(cell: str, model):
    config = copy.deepcopy(harness.load_cell(cell).config)
    config["model"].update(model)
    return config


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_fails_the_logit_gap(seed):
    """Greedy tokens of the f32 reference served; the fp8 control's top
    token at the same positions lies further below the reference's best
    than the limit allows (the f32 tokens themselves read 0)."""
    config = sized("nemo12b.rag.batch", MID)
    params = serve_sys.make_weights(config, seed, "cpu")
    reqs = []
    for uid in (1, 2, 3):
        r = loadgen.Record(uid, 96, 24, seed, MID["vocab_size"])
        r.tokens = llama.decode_greedy(params, config["model"],
                                       torch.as_tensor(r.prompt()), 24)
        r.finished = True
        reqs.append(r)
    limit = config["limits"]["max_logit_gap"]
    assert max(serve_sys.logit_gaps(params, config["model"], reqs,
                                    "cpu")) == 0.0
    ctl = serve_sys.logit_gaps(params, config["model"], reqs, "cpu",
                               fp8=True)
    assert max(ctl) > limit


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_train_control_fails_a_number(seed):
    """Three steps of the fp8 control against the f32 reference on the
    same weights and rows: at least one compared number over its limit."""
    cell = harness.load_cell("smollm135m.train.s2048")
    config = sized(cell.name, SMALL)
    p = dict(cell.workload["params"], batch=2, seq=24)
    params0 = serve_sys.make_weights(config, seed, "cpu")
    corpus = train_steps.Corpus(SMALL["vocab_size"], seed, p["noise"])
    batches = [torch.as_tensor(corpus.batch(i, p["batch"], p["seq"]))
               for i in range(int(p["first_steps"]))]
    hp, lim = config["optimizer"], config["limits"]
    ref = train_sys.reference_steps(params0, config["model"], hp, batches)
    ctl = train_sys.reference_steps(params0, config["model"], hp, batches,
                                    fp8=True)
    got = train_sys.compare(ctl, ref)
    assert any(got[k] > lim[k] for k in got if k in lim), got
