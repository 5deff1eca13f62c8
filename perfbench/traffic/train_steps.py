"""Training steps back to back: each step a fresh batch of ``batch``
sequences of ``seq`` tokens from the benchmark's synthetic corpus (a
seeded Markov chain: token t + 1 follows token t through a fixed random
permutation, a ``noise`` share of positions drawn at random), fed and
stepped through the trainer's own call and ended by the read of its
loss. The first ``first_steps`` steps run in set-up; the window runs
whole steps until ``--seconds`` have passed and closes at the end of
the last one. A traced run profiles ``profile_steps`` steps in the
middle of its window.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np


class Corpus:
    """Step ``i``'s batch is a function of (seed, i) alone, so the
    reference reads the same rows."""

    def __init__(self, vocab: int, seed: int, noise: float):
        self.vocab, self.seed, self.noise = vocab, int(seed), float(noise)
        self.perm = np.random.default_rng([self.seed, 3]).permutation(vocab)

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 4, step])
        noise = rng.random((seq, batch)) < self.noise
        rand = rng.integers(0, self.vocab, (seq, batch))
        toks = np.empty((seq, batch), np.int64)
        toks[0] = rand[0]
        for t in range(1, seq):
            toks[t] = np.where(noise[t], rand[t], self.perm[toks[t - 1]])
        return np.ascontiguousarray(toks.T).astype(np.int32)


def run(train, cell, seed: int, seconds: float, trace: bool, harness
        ) -> Dict:
    """The window: steps from ``train.step`` until ``seconds`` have
    passed, each timed on the host clock (it ends in the loss's read)."""
    import torch
    p = cell.workload["params"]
    out: Dict = {"steps": [],
                 "peak_setup_bytes": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    t_open = time.perf_counter()
    prof_from = None
    while True:
        i = len(out["steps"])
        mid = time.perf_counter() - t_open >= (seconds - p["slice_s"]) / 2
        if trace and prof_from is None and mid:
            prof_from = i
            with harness.Profiled(train.spans) as prof:
                for _ in range(int(p["profile_steps"])):
                    out["steps"].append(dict(train.step(), profiled=True))
            out["profiled"] = [prof]
        else:
            out["steps"].append(dict(train.step(), profiled=False))
        if out["steps"][-1]["t1"] - t_open >= seconds:
            break
    out["t_open"], out["t_close"] = t_open, out["steps"][-1]["t1"]
    out["peak_window_bytes"] = torch.cuda.max_memory_allocated()
    return out
