"""Synthetic data pipeline: Zipf-distributed token streams with learnable
bigram structure.

Serving the paper's theme end-to-end: token *unigrams* follow Zipf(1.1) (like
the paper's content popularity) and transitions follow a fixed random bigram
table, so a language model has real signal to learn (loss decreases
measurably within a few hundred steps at 100M scale) while the marginal
distribution stresses the same skew the cache policies see.

Determinism + elasticity: batch(step, host_id, num_hosts) is a pure function —
restart/resume and host-count changes (elastic re-sharding) reproduce the
exact same global stream.

A copy of the reference's ``train/data.py`` (numpy only), held to it bit for
bit by tests/test_torch_train.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import zipf as zipf_mod


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    alpha: float = 1.1
    bigram_temp: float = 1.5  # lower = more learnable structure
    seed: int = 1234


class ZipfBigramStream:
    """Deterministic, shardable synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # stationary Zipf unigram over tokens (rank-ordered ids)
        self._unigram = zipf_mod.zipf_probs(v, cfg.alpha)
        # each token prefers a small random successor set, tempered toward
        # the Zipf marginal: p(next|cur) ~ unigram * gumbel-perturbed boost
        self._succ = rng.integers(0, v, size=(v, 4))
        self._succ_w = 0.7

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        b_local = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + host_id
        )
        b, s, v = b_local, cfg.seq_len, cfg.vocab_size
        cdf = np.cumsum(self._unigram)
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = np.searchsorted(cdf, rng.random(b))
        for t in range(1, s):
            # with prob succ_w follow the bigram successor table, else Zipf
            follow = rng.random(b) < self._succ_w
            pick = self._succ[toks[:, t - 1], rng.integers(0, 4, b)]
            fresh = np.searchsorted(cdf, rng.random(b))
            toks[:, t] = np.where(follow, pick, fresh)
        return {"tokens": toks.astype(np.int32)}


def make_stream(vocab_size: int, seq_len: int, global_batch: int, seed: int = 1234) -> ZipfBigramStream:
    return ZipfBigramStream(DataConfig(vocab_size, seq_len, global_batch, seed=seed))
