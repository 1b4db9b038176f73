"""Deterministic sharded token pipeline — a copy of
``repro.data.pipeline`` (pure numpy), kept here so the port never imports
the JAX package. The same (seed, step, rows) give bit-equal batches in both
packages; ``train.loop`` hands them to the device as int64 tensors.

Production posture: each data-parallel host reads only its shard of the
global batch (``host_batch_slice``), the stream is a pure function of
(seed, step) so any restart/elastic-resize resumes exactly (no state to
checkpoint beyond the step counter), and backing sources are pluggable:

  * SyntheticLM   — zipf-ish token stream (default for benches/smoke)
  * MemmapSource  — packed uint16/uint32 token file (np.memmap), the
                    standard on-disk format for real corpora
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["SyntheticLM", "MemmapSource", "LMBatcher", "host_batch_slice"]


def host_batch_slice(global_batch: int, n_hosts: int, host_id: int
                     ) -> Tuple[int, int]:
    """[start, stop) rows of the global batch owned by this host."""
    assert global_batch % n_hosts == 0, (global_batch, n_hosts)
    per = global_batch // n_hosts
    return host_id * per, (host_id + 1) * per


class SyntheticLM:
    """Deterministic synthetic LM tokens: stateless function of (seed, step).

    Tokens follow a zipf-like marginal with short-range structure so losses
    are non-trivial and decreasing under training."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int,
              rows: Optional[Tuple[int, int]] = None) -> np.ndarray:
        lo, hi = rows or (0, batch)
        out = np.empty((hi - lo, seq + 1), np.int32)
        for i, row in enumerate(range(lo, hi)):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 131_071 + row)
            base = rng.zipf(1.4, size=seq + 1).astype(np.int64)
            tok = (base + rng.integers(0, 7, size=seq + 1)) % self.vocab
            # inject copy structure: second half repeats first half shifted
            half = (seq + 1) // 2
            tok[half:half * 2] = tok[:half]
            out[i] = tok.astype(np.int32)
        return out


class MemmapSource:
    """Packed token file: flat uint16/uint32 stream, sampled by (seed, step)."""

    def __init__(self, path: str, vocab: int, dtype=np.uint16, seed: int = 0):
        self.arr = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int,
              rows: Optional[Tuple[int, int]] = None) -> np.ndarray:
        lo, hi = rows or (0, batch)
        n = len(self.arr) - (seq + 1)
        out = np.empty((hi - lo, seq + 1), np.int32)
        for i, row in enumerate(range(lo, hi)):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 131_071 + row)
            start = int(rng.integers(0, n))
            out[i] = self.arr[start:start + seq + 1].astype(np.int32)
        return out


@dataclasses.dataclass
class LMBatcher:
    """Turns a source into next-token-prediction batches."""
    source: object
    batch: int
    seq: int
    rows: Optional[Tuple[int, int]] = None

    def get(self, step: int) -> dict:
        tokens = self.source.batch(step, self.batch, self.seq, self.rows)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.get(step)
            step += 1
