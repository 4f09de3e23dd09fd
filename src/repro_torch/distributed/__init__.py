"""Training-side workloads (port of ``repro/distributed``, in part).

:mod:`~repro_torch.distributed.checkpoint` (compressed train-state
checkpoints) and :mod:`~repro_torch.distributed.compression` (the gradient
compressor's transform and replica-axis mean).  The sharding policy, the
train step, the optimizer and the compressor's collective ``all_reduce``
come with the LM stack.
"""
