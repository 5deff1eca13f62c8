"""The work counts against hand counts at small shapes, their dependence
on shapes and live tiles alone, and the configurations' parameters."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


TINY = {"hidden_size": 8, "intermediate_size": 12, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 4, "num_hidden_layers": 3,
        "vocab_size": 10, "tie_word_embeddings": False}


def test_parameter_counts_are_the_published_models():
    assert round(work.n_params(model("nemo12b-serve")) / 1e9, 2) == 12.25
    assert round(work.n_params(model("smollm135m-train")) / 1e6, 1) == 134.5


def test_step_flops_by_hand():
    # A layer: q 8x8, k and v 8x4 each, o 8x8, three 8x12 MLP matrices.
    per_layer = 2 * (64 + 32 + 32 + 64 + 3 * 96)
    assert work.layer_matmul_flops(TINY) == per_layer
    # Attention: 2 heads x 4 dims x 2 products x 2 FLOPs per key, 3 layers.
    assert work.attn_flops(TINY, 5) == 4 * 2 * 4 * 5 * 3
    # A prompt of 3: tokens 1..3 attend over 1, 2, 3 keys; one head row.
    assert work.prefill_flops(TINY, 3) == (
        3 * 3 * per_layer + 4 * 2 * 4 * 3 * 6 + 2 * 8 * 10)
    assert work.decode_flops(TINY, 7) == (3 * per_layer + 4 * 2 * 4 * 3 * 7
                                          + 2 * 8 * 10)
    fwd = 4 * 3 * per_layer + 4 * 2 * 4 * 3 * 10 + 3 * 2 * 8 * 10
    assert work.train_flops(TINY, 2, 4) == 3 * 2 * fwd


def test_paged_gqa_by_hand():
    w = work.paged_gqa(3, 2, 4, 8, 16, [0, 5, 17], elt=2)
    assert w["flops"] == 4 * 4 * 2 * 8 * 22
    assert w["bytes"] == 2 * (2 * 22 * 2 * 8 + 2 * 3 * 2 * 4 * 8) + 4 * (
        3 + 0 + 1 + 2)


@pytest.mark.parametrize("gate", ["lhs", "rhs"])
def test_gated_gemm_by_hand(gate):
    # M 5 (tiles 4 + 1), K 6 (2 + 2 + 2), N 3 (tiles 2 + 1).
    if gate == "lhs":
        bits = np.array([[0, 1, 1], [1, 1, 0]])
        flops = 2 * (4 * 2 + 1 * 2) * 3
        xb, wb, nb = 4 * 2 + 1 * 2, (2 + 2) * 3, 6
    else:
        bits = np.array([[0, 1], [1, 1], [1, 0]])
        flops = 2 * 5 * (2 * 2 + 2 * 1)
        xb, wb, nb = 5 * (2 + 2), 2 * 2 + 2 * 1, 6
    w = work.gated_gemm(5, 6, 3, 4, 2, 2, gate, bits, 2, 2, 4)
    assert w["flops"] == flops
    assert w["bytes"] == 2 * xb + 2 * wb + 4 * 5 * 3 + 4 * nb


def test_work_depends_on_shapes_and_live_tiles_only():
    """Same shapes and bits give the same work whatever else; every
    dead tile lowers it; all dead leaves the bound's floor."""
    rng = np.random.default_rng(0)
    bits = (rng.random((8, 6)) < 0.5).astype(np.int32)
    a = work.gated_gemm(64, 96, 48, 8, 16, 16, "lhs", bits, 2, 2, 2)
    assert a == work.gated_gemm(64, 96, 48, 8, 16, 16, "lhs", bits.copy(),
                                2, 2, 2)
    more = bits.copy()
    i, j = np.argwhere(bits == 0)[0]
    more[i, j] = 1
    b = work.gated_gemm(64, 96, 48, 8, 16, 16, "lhs", more, 2, 2, 2)
    assert b["flops"] < a["flops"]
    assert work.paged_gqa(4, 8, 4, 128, 16, [0, 0, 0, 0], 2)["flops"] == 0
    assert (work.paged_gqa(4, 8, 4, 128, 16, [5, 0, 0, 0], 2)
            == work.paged_gqa(4, 8, 4, 128, 16, [0, 0, 5, 0], 2))
    g = work.gated_gemm(64, 64, 64, 16, 16, 16, "lhs",
                        np.ones((4, 4), np.int32), 2, 2, 2)
    assert g["flops"] == 0 and g["bytes"] == 2 * 64 * 64 + 4 * 16


def test_peaks_are_the_h100s():
    assert work.PEAK_FLOPS == 989.4e12 and work.HBM_BW == 3.35e12
