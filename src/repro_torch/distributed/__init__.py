"""Training-side workloads (port of ``repro/distributed``, in part).

:mod:`~repro_torch.distributed.checkpoint` (compressed train-state
checkpoints), :mod:`~repro_torch.distributed.compression` (the gradient
compressor's transform and replica-axis mean),
:mod:`~repro_torch.distributed.optimizer` (AdamW),
:mod:`~repro_torch.distributed.train` (the train step on one device and
``make_serve_fns``) and :mod:`~repro_torch.distributed.elastic`
(``StepTimer``).  The sharding policy, the pod-compressed train step and
the compressor's collective ``all_reduce`` come with the multi-device
layer.
"""
