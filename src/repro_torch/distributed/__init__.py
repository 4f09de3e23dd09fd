"""Training-side workloads and the multi-device layer (port of
``repro/distributed``).

:mod:`~repro_torch.distributed.checkpoint` (compressed train-state
checkpoints), :mod:`~repro_torch.distributed.compression` (the gradient
compressor: its transform, the replica-axis mean in one process and on
ranks, and the collective ``all_reduce``),
:mod:`~repro_torch.distributed.optimizer` (AdamW),
:mod:`~repro_torch.distributed.sharding` (the sharding policy),
:mod:`~repro_torch.distributed.train` (the train step on one device,
pod-compressed across ranks and FSDP over ``data``; ``make_serve_fns``)
and :mod:`~repro_torch.distributed.elastic` (``remesh``,
``validate_mesh_for``, ``StepTimer``).  The ``model`` axis (tensor
parallelism, the distributed MoE) is not ported.
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
