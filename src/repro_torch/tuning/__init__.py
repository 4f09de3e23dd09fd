"""Cost-model-driven tuning for the serving engines and the H100 kernels.
Port of ``repro/tuning``.

Three shape decisions:

  * **bucket edges** — :mod:`repro_torch.tuning.policy` makes the padding
    ladder a declarative :class:`BucketPolicy` (``p2`` / ``half-octave`` /
    ``cost-balanced``) with the count of bucket shapes bounded;
  * **kernel launch shapes** — ``lut_idct``'s and ``encode_levels``'
    register tiles and the v3 stage's tile are swept on the card by
    :func:`repro_torch.tuning.autotune.tune` and persisted in an on-disk
    :class:`TuningCache` (``FPTC_TUNING_CACHE``) keyed by (backend, plan
    key, bucket shape);
  * **shard splits** — the scheduler splits each key group at
    cost-balanced boundaries over per-signal costs predicted by
    :class:`repro_torch.tuning.cost_model.CostModel`.

None of these change produced bytes: policies and launch shapes move *when
and where* work runs.
"""
from repro_torch.tuning.cost_model import (
    BackendProfile,
    CostModel,
    default_cost_model,
)
from repro_torch.tuning.policy import (
    BucketPolicy,
    COST_BALANCED,
    HALF_OCTAVE,
    P2,
    cost_balanced_policy,
)
from repro_torch.tuning.autotune import (
    TuningCache,
    default_cache,
    epoch,
    set_default_cache,
    tune,
    tuned_blocks,
)

__all__ = [
    "BackendProfile",
    "CostModel",
    "default_cost_model",
    "BucketPolicy",
    "P2",
    "HALF_OCTAVE",
    "COST_BALANCED",
    "cost_balanced_policy",
    "TuningCache",
    "default_cache",
    "set_default_cache",
    "epoch",
    "tune",
    "tuned_blocks",
]
