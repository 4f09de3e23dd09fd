"""Elastic scaling + straggler mitigation utilities.
Port of ``repro/distributed/elastic.py``.

Elasticity contract: checkpoints are *sharding-agnostic* (host numpy
trees), so a job restarted with a different rank count rebuilds the mesh
and places each leaf anew — provided the new axis sizes still divide the
dims they shard.  ``remesh`` performs that placement and
``validate_mesh_for`` pre-checks divisibility so a bad mesh fails fast
instead of mid-restore.

Straggler mitigation: the data pipeline is index-addressed, so a
replacement host resumes the dead host's stream with no coordination; step
barriers are the collectives themselves.  ``StepTimer`` keeps an EWMA of
step latency and flags outliers — on a cluster this feeds the controller's
preemption/respawn decision.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Tuple

from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.models.common import ParamSpec

PyTree = Any

__all__ = ["remesh", "validate_mesh_for", "StepTimer"]


def _spec_leaves(specs: PyTree, path: str = ""):
    """``(keystr-like path, spec)`` of every ParamSpec leaf."""
    if isinstance(specs, ParamSpec):
        yield path, specs
        return
    for k in sorted(specs):
        yield from _spec_leaves(specs[k], f"{path}[{k!r}]")


def validate_mesh_for(policy: ShardingPolicy, specs: PyTree) -> List[str]:
    """Return a list of human-readable problems (empty == mesh is valid).

    A dim that *loses* sharding under the new mesh is allowed (replication
    is always legal); what we check is that every sharded dim divides
    evenly.
    """
    problems: List[str] = []
    for path, s in _spec_leaves(specs):
        spec = policy.spec_for(s.names, s.shape)
        for dim, entry in zip(s.shape, spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            total = 1
            for a in axes:
                total *= policy.axis_sizes[a]
            if dim % total:
                problems.append(
                    f"{path}: dim {dim} not divisible "
                    f"by mesh axes {axes} (={total})"
                )
    return problems


def remesh(host_tree: PyTree, specs: PyTree, new_policy: ShardingPolicy
           ) -> PyTree:
    """Place a host tree (numpy arrays, or tensors as ``restore_latest``
    returns bfloat16 leaves) onto a new mesh per the policy: each leaf
    becomes a ``DTensor`` whose local tensor is this rank's block, on the
    mesh's device type (no collective: every rank holds the host tree).

    This is the elastic-restart path: restore_latest() -> remesh() -> resume.
    """
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models.convert import to_torch

    problems = validate_mesh_for(new_policy, specs)
    if problems:
        raise ValueError(
            "mesh incompatible with parameter shapes:\n  "
            + "\n  ".join(problems)
        )
    mesh = new_policy.mesh
    coord = mesh.get_coordinate()
    device = (torch.device("cpu") if mesh.device_type == "cpu"
              else torch.device(mesh.device_type,
                                torch.cuda.current_device()))

    def place(arr, s: ParamSpec):
        full = tuple(arr.shape)
        block = arr[new_policy.local_slices(s.names, full, coord)]
        local = (block.contiguous().to(device)
                 if isinstance(block, torch.Tensor)
                 else to_torch(np.ascontiguousarray(block), device))
        return DTensor.from_local(
            local, mesh, new_policy.placements_for(s.names, full),
            run_check=False, shape=torch.Size(full),
            stride=torch.empty(full, device="meta").stride())

    def walk(tree, spec):
        if isinstance(spec, ParamSpec):
            return place(tree, spec)
        return {k: walk(tree[k], spec[k]) for k in spec}

    return walk(host_tree, specs)


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
