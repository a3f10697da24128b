"""Deterministic synthetic LM data pipeline: a numpy copy of the JAX
package's, whose batches are bit-identical to the reference's for every
``(seed, step)``.

Stateless-by-construction: batch ``i`` is a pure function of (seed, i), so
fault-tolerant resume needs only the step counter from the checkpoint — no
data-iterator state to snapshot, no skew after elastic re-scaling (the global
batch is re-sharded by the mesh, not by the pipeline).

The token stream is a mixture of structured sources (repeats, arithmetic-ish
progressions, markov chains) so tiny models show a real, decreasing loss.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0     # vlm/audio stub embeddings
    d_model: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        kind = rng.choice([0, 0, 1, 2], size=(b,))  # repeats dominate: learnable fast
        toks = np.empty((b, s + 1), np.int32)
        for i in range(b):
            if kind[i] == 0:      # period-k repeats
                k = int(rng.integers(2, 8))
                base = rng.integers(0, v, size=(k,))
                toks[i] = np.resize(base, s + 1)
            elif kind[i] == 1:    # affine progression mod v
                a = int(rng.integers(1, 7))
                c = int(rng.integers(0, v))
                toks[i] = (c + a * np.arange(s + 1)) % v
            else:                 # 2-gram markov with few states
                states = rng.integers(0, v, size=(16,))
                idx = rng.integers(0, 16, size=(s + 1,))
                idx = np.maximum.accumulate(idx) % 16
                toks[i] = states[idx]
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32) * 0.1
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_pipeline(model_cfg, *, global_batch: int, seq_len: int,
                  seed: int = 0) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        frontend_tokens=model_cfg.frontend_tokens
        if model_cfg.family in ("vlm", "audio") else 0,
        d_model=model_cfg.d_model))


def as_tensors(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: token arrays (``tokens``,
    ``targets``, ``enc_tokens``) as int64, float arrays as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out
