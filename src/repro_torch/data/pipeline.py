"""Deterministic, host-sharded token data pipeline.

Port of ``repro/data/pipeline.py`` (numpy only, so its batches equal the
reference's exactly). A synthetic corpus (a structured pseudo-language:
token t+1 follows token t through a fixed random permutation, with
noise, so the loss decreases) or a memory-mapped ``.npy`` token file.
Each host reads only its own batch shard (``host_slice``), and batches
are keyed by step, so a restart reproduces them without data-state
checkpoints: the step index is the data state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.modules import torch_dtype


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    noise: float = 0.1  # fraction of random tokens
    path: Optional[str] = None  # binary .npy token file (optional)


class SyntheticCorpus:
    """Markov-ish synthetic tokens: learnable but nontrivial."""

    def __init__(self, vocab: int, cfg: DataConfig):
        self.vocab = vocab
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(vocab)

    def batch(self, step: int, batch: int, seq: int,
              codebooks: int = 0) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, step))
        shape = (batch, codebooks, seq) if codebooks else (batch, seq)
        first = rng.integers(0, self.vocab, shape[:-1])
        toks = np.empty(shape, np.int32)
        toks[..., 0] = first
        for t in range(1, seq):
            nxt = self.perm[toks[..., t - 1]]
            noise = rng.random(shape[:-1]) < self.cfg.noise
            rand = rng.integers(0, self.vocab, shape[:-1])
            toks[..., t] = np.where(noise, rand, nxt)
        return toks


class FileCorpus:
    """Random windows of a memory-mapped 1-D ``.npy`` token file."""

    def __init__(self, path: str, vocab: int):
        self.tokens = np.load(path, mmap_mode="r")
        self.vocab = vocab

    def batch(self, step: int, batch: int, seq: int,
              codebooks: int = 0) -> np.ndarray:
        n = self.tokens.shape[0] - seq - 1
        rng = np.random.default_rng(step)
        starts = rng.integers(0, n, batch)
        out = np.stack([self.tokens[s: s + seq] for s in starts])
        return out.astype(np.int32)


def host_slice(global_batch: int, host_id: int, n_hosts: int) -> slice:
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


def make_batch_iterator(
    cfg: ArchConfig, shape: ShapeConfig, data_cfg: DataConfig,
    *, start_step: int = 0, host_id: int = 0, n_hosts: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy batches from ``start_step`` on: ``tokens`` int32 (B, S)
    (audio (B, K, S); vlm (B, S - num_patches) text behind seeded f32
    ``patch_embeds`` (B, P, d))."""
    corpus = (
        FileCorpus(data_cfg.path, cfg.vocab_size)
        if data_cfg.path
        else SyntheticCorpus(cfg.vocab_size, data_cfg)
    )
    sl = host_slice(shape.global_batch, host_id, n_hosts)
    step = start_step
    cb = cfg.num_codebooks if cfg.frontend == "codes" else 0
    text_len = shape.seq_len
    if cfg.frontend == "patches":
        text_len = shape.seq_len - cfg.num_patches
    while True:
        toks = corpus.batch(step, shape.global_batch, text_len, cb)[sl]
        batch: Dict[str, np.ndarray] = {"tokens": toks}
        if cfg.frontend == "patches":
            rng = np.random.default_rng((data_cfg.seed, step, 7))
            b = toks.shape[0]
            batch["patch_embeds"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model), dtype=np.float32
            )
        yield batch
        step += 1


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each batch entry at ``shape``, allocating
    nothing (the vlm's backbone sequence is patches + text = S)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "codes":
        toks = ((B, cfg.num_codebooks, S), torch.int32)
    elif cfg.frontend == "patches":
        toks = ((B, S - cfg.num_patches), torch.int32)
    else:
        toks = ((B, S), torch.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "patches":
        batch["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model),
                                 torch_dtype(cfg.dtype))
    return batch
