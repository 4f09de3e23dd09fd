"""Data pipelines: signal strips for the codec, token batches for LM training.
Port of ``repro/data/pipeline.py`` (numpy, unchanged).

Both pipelines are deterministic, shardable by (host_id, num_hosts) for
multi-host data parallelism, and restartable from a step index (fault
tolerance: a restore at step k re-produces batch k exactly).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.data import signals

__all__ = ["SignalPipeline", "TokenPipeline"]


@dataclasses.dataclass
class SignalPipeline:
    """Streams fixed-length signal strips from a (synthetic) dataset.

    Mirrors the paper's acquisition model: each strip is one encoder unit of
    work.  Sharding: host h of H draws strips h, h+H, h+2H, ...
    """

    dataset: str
    strip_length: int = 65536
    host_id: int = 0
    num_hosts: int = 1
    seed: int = 0

    def strip(self, index: int) -> np.ndarray:
        global_index = index * self.num_hosts + self.host_id
        return signals.make_signal(
            self.dataset, self.strip_length, seed=self.seed + global_index
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        i = 0
        while True:
            yield self.strip(i)
            i += 1

    def calibration_strip(self, length: Optional[int] = None) -> np.ndarray:
        """A held-out strip (negative seed space) for table calibration."""
        return signals.make_signal(
            self.dataset, length or self.strip_length, seed=self.seed - 1_000_003
        )


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic synthetic token batches for LM train/dry-run drivers.

    Batch b is a pure function of (seed, step, host shard) — restartable and
    shardable without coordination.  Tokens follow a Zipfian marginal so the
    loss curves are non-degenerate.
    """

    vocab_size: int
    batch_size: int  # per-host batch
    seq_len: int
    host_id: int = 0
    num_hosts: int = 1
    seed: int = 0

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65537 + self.host_id
        )
        # Zipf-ish marginal via exponential of uniform
        u = rng.random((self.batch_size, self.seq_len + 1))
        ranks = np.floor(
            np.exp(u * np.log(self.vocab_size)) - 1.0
        ).astype(np.int32)
        tokens = np.clip(ranks, 0, self.vocab_size - 1)
        return tokens[:, :-1], tokens[:, 1:]

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
