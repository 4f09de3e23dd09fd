"""Training-side workloads (port of ``repro/distributed``, in part).

:mod:`~repro_torch.distributed.checkpoint` (compressed train-state
checkpoints) and :mod:`~repro_torch.distributed.compression` (the gradient
compressor's transform and replica-axis mean), and the serving half of
:mod:`~repro_torch.distributed.train` (``make_serve_fns``).  The sharding
policy, the train step, the optimizer and the compressor's collective
``all_reduce`` come with the rest of the LM stack.
"""
