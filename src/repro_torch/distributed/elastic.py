"""Straggler timing.  Port of ``repro/distributed/elastic.py``, in part.

``StepTimer`` keeps an EWMA of step latency and flags outliers; on a
cluster it feeds the controller's preemption/respawn decision.  ``remesh``
and ``validate_mesh_for`` place a checkpoint's host tree onto a new mesh by
the sharding policy, which comes with the multi-device layer (ROADMAP
queue 1, item 6, M10d).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

__all__ = ["StepTimer"]


@dataclasses.dataclass
class StepTimer:
    """EWMA step-latency tracker; flags straggling steps."""

    alpha: float = 0.1
    threshold: float = 2.0  # x EWMA => straggler
    ewma: Optional[float] = None
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> Tuple[float, bool]:
        dt = time.monotonic() - self._t0
        straggler = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self.ewma
        )
        return dt, straggler
