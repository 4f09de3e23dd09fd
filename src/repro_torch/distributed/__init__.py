"""Training-side workloads and the multi-device layer (port of
``repro/distributed``).

:mod:`~repro_torch.distributed.checkpoint` (compressed train-state
checkpoints), :mod:`~repro_torch.distributed.compression` (the gradient
compressor: its transform, the replica-axis mean in one process and on
ranks, and the collective ``all_reduce``),
:mod:`~repro_torch.distributed.optimizer` (AdamW),
:mod:`~repro_torch.distributed.sharding` (the sharding policy, the
``model`` axis's collectives and ``ModelAxis``),
:mod:`~repro_torch.distributed.train` (the train step on one device,
pod-compressed across ranks, FSDP over ``data`` with tensor, sequence and
expert parallelism over ``model``; ``make_serve_fns`` on a device or a
mesh) and :mod:`~repro_torch.distributed.elastic` (``remesh``,
``validate_mesh_for``, ``StepTimer``).
"""
from repro_torch.distributed.sharding import (
    ShardingPolicy,
    activate,
    constrain,
    current_policy,
    resolve_param_specs,
)

__all__ = [
    "ShardingPolicy",
    "activate",
    "constrain",
    "current_policy",
    "resolve_param_specs",
]
