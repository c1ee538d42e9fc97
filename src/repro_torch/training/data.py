"""Data pipeline: deterministic synthetic corpora per architecture family
(the port's own copy of ``repro.training.data``: numpy only, the same
batches bit for bit).

Batches are generated from a counter-seeded PRNG, so the pipeline is
(a) infinite, (b) deterministically resumable from a step index after restart
(the same guarantee a production sharded-file loader provides via per-step
shard bookkeeping), and (c) identical across hosts — each host slices its
data-parallel shard from the global batch by process index.

The token stream is a Zipf-distributed "language" with document boundaries —
enough structure for loss curves to be meaningfully decreasing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    zipf_a: float = 1.3
    doc_len_mean: int = 512
    bos_token: int = 1


class TokenPipeline:
    """Deterministic, restartable synthetic LM data."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # precompute a Zipf-ish categorical over the vocab
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self.probs = p / p.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab, size=(B, S + 1), p=self.probs).astype(np.int32)
        # inject document boundaries: bos then a copied "topic" token run —
        # makes next-token prediction learnable
        n_docs = max((S + 1) // cfg.doc_len_mean, 1)
        for b in range(B):
            starts = rng.integers(0, S, size=n_docs)
            for s in starts:
                toks[b, s] = cfg.bos_token
                run = min(int(rng.integers(4, 16)), S - s)
                if run > 2:
                    topic = rng.integers(2, cfg.vocab)
                    toks[b, s + 1 : s + run : 2] = topic
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "loss_mask": np.ones((B, S), np.float32),
        }

    def host_batch(self, step: int, process_index: int = 0, process_count: int = 1):
        """The slice of the global batch this host feeds (multi-host feed)."""
        b = self.batch(step)
        B = self.cfg.global_batch
        per = B // process_count
        sl = slice(process_index * per, (process_index + 1) * per)
        return {k: v[sl] for k, v in b.items()}


class AudioPipeline:
    """Synthetic frame-feature batches for the encoder-only (HuBERT) family."""

    def __init__(self, seq_len: int, global_batch: int, vocab: int,
                 feat_dim: int, mask_prob: float = 0.08, seed: int = 0):
        self.seq_len, self.global_batch = seq_len, global_batch
        self.vocab, self.feat_dim = vocab, feat_dim
        self.mask_prob, self.seed = mask_prob, seed

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        # cluster targets correlate with frame features (learnable)
        targets = rng.integers(0, self.vocab, size=(B, S)).astype(np.int32)
        centroids = np.random.default_rng(self.seed).normal(
            size=(self.vocab, self.feat_dim)).astype(np.float32)
        frames = centroids[targets] + 0.5 * rng.normal(size=(B, S, self.feat_dim)).astype(np.float32)
        mask = (rng.random((B, S)) < self.mask_prob).astype(np.float32)
        return {"frames": frames, "mask": mask, "targets": targets}


def make_pipeline(arch_cfg, seq_len: int, global_batch: int, seed: int = 0):
    if arch_cfg.family == "audio":
        return AudioPipeline(seq_len, global_batch, arch_cfg.vocab,
                             arch_cfg.frame_feat_dim, arch_cfg.mask_prob, seed)
    return TokenPipeline(DataConfig(seq_len=seq_len, global_batch=global_batch,
                                    vocab=arch_cfg.vocab, seed=seed))
