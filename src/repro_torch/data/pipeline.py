"""Deterministic data pipeline: synthetic LM stream + token-file backend.

Determinism contract (fault tolerance): batch at step ``s`` depends only on
(seed, s, host shard) — a restarted/elastic job regenerates the exact
stream from the checkpointed step, on any host layout.

SyntheticLM produces a *learnable* distribution (bigram chain with noise),
so integration tests can assert loss decreases.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: this host's shard (process index, process count)
    shard: tuple = (0, 1)

    @property
    def host_batch(self) -> int:
        idx, n = self.shard
        assert self.global_batch % n == 0
        return self.global_batch // n


class SyntheticLM:
    """Markov-chain synthetic corpus; next-token structure is learnable."""

    def __init__(self, cfg: DataConfig, order_seed: int = 1234):
        self.cfg = cfg
        rng = np.random.default_rng(order_seed)
        # deterministic "grammar": each token maps to a preferred successor
        self._succ = rng.permutation(cfg.vocab_size)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        idx, n = cfg.shard
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + idx)
        B, S = cfg.host_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
        noise = rng.random((B, S)) < 0.1
        rand_next = rng.integers(0, cfg.vocab_size, (B, S))
        for t in range(S):
            nxt = self._succ[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_next[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class TokenFileDataset:
    """Binary token file (np.int32 memmap) chopped into sequences.

    The production path: a pre-tokenized corpus on shared storage, read
    with zero-copy memmap; epoch shuffling is a seeded permutation of
    sequence indices so every host computes the same order independently.
    """

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=np.int32, mode="r")
        self.n_seqs = (len(self._data) - 1) // cfg.seq_len
        if self.n_seqs <= 0:
            raise ValueError(f"{path} too small for seq_len={cfg.seq_len}")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        idx, n = cfg.shard
        epoch_len = self.n_seqs // cfg.global_batch
        epoch, within = divmod(step, max(epoch_len, 1))
        order = np.random.default_rng(cfg.seed + epoch).permutation(
            self.n_seqs)
        base = (within * cfg.global_batch + idx * cfg.host_batch) \
            % self.n_seqs
        rows = []
        for i in range(cfg.host_batch):
            s = order[(base + i) % self.n_seqs] * cfg.seq_len
            rows.append(self._data[s:s + cfg.seq_len + 1])
        toks = np.stack([r if len(r) == cfg.seq_len + 1
                         else np.pad(r, (0, cfg.seq_len + 1 - len(r)))
                         for r in rows]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_dataset(cfg: DataConfig, path: Optional[str] = None):
    if path and os.path.exists(path):
        return TokenFileDataset(cfg, path)
    return SyntheticLM(cfg)
