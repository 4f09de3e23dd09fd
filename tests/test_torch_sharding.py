"""The sharding policy and ``validate_mesh_for`` held against the JAX
package's (pure logic: no process group, no device).

* every leaf of the ten full configurations' parameter specs (the port's
  ``meta`` models, the reference's abstract specs) resolves to the
  reference's ``PartitionSpec`` entries on the 16 x 16, 2 x 16 x 16 and 3
  x 5 meshes, with every axis and without ``pod``; ``validate_mesh_for``
  lists the same problems;
* the reference's own policy cases (``tests/test_distributed.py``) against
  the port;
* the placements and the block a mesh position holds: a dim over two axes
  splits over the first, then the second, as in JAX and DTensor.
"""
import functools

import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed.elastic import (  # noqa: E402
    validate_mesh_for as ref_validate_mesh_for,
)
from repro.distributed.sharding import DEFAULT_RULES as REF_RULES  # noqa: E402
from repro.distributed.sharding import (  # noqa: E402
    ShardingPolicy as RefShardingPolicy,
)
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.common import ParamSpec as RefParamSpec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed.elastic import validate_mesh_for  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    DEFAULT_RULES,
    ShardingPolicy,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.api import spec_leaves  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402


class FakeMesh:
    """Axis-size stand-in for spec resolution (no devices needed), as the
    reference's tests have it."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "3x5": {"data": 3, "model": 5}}


@functools.lru_cache(maxsize=None)
def both_specs(arch: str):
    """``{path: (port spec, reference spec)}`` of every parameter leaf."""
    ref = ref_build_model(ref_configs.get_arch(arch)).param_specs()
    flat = {tuple(k.key for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: isinstance(x, RefParamSpec))[0]}
    port = dict(spec_leaves(build_model(configs.get_arch(arch),
                                        device="meta").param_specs()))
    assert set(port) == set(flat)
    return {k: (port[k], flat[k]) for k in port}


def test_rules_are_the_reference_s():
    assert DEFAULT_RULES == REF_RULES


@pytest.mark.parametrize("without_pod", [False, True],
                         ids=["every-axis", "without-pod"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_every_leaf_resolves_as_the_reference(arch, mesh, without_pod):
    fake = FakeMesh(MESHES[mesh])
    port, ref = ShardingPolicy(fake), RefShardingPolicy(fake)
    if without_pod:
        port, ref = port.without("pod"), ref.without("pod")
    assert port.fsdp_axes == ref.fsdp_axes
    specs = both_specs(arch)
    for path, (mine, theirs) in specs.items():
        assert mine.shape == theirs.shape and mine.names == theirs.names, \
            path
        assert port.spec_for(mine.names, mine.shape) == tuple(
            ref.spec_for(theirs.names, theirs.shape)), path
    assert validate_mesh_for(port, {p: s for p, (s, _) in specs.items()}
                             ) == ref_validate_mesh_for(
        ref, {p: s for p, (_, s) in specs.items()})


def test_policy_divisibility_fallback():
    policy = ShardingPolicy(FakeMesh({"data": 16, "model": 16}))
    # 20 heads on a 16-way model axis -> replicated
    assert policy.spec_for(("hidden", "heads", None),
                           (2560, 20, 128)) == ("data",)
    # 32 heads -> sharded
    assert policy.spec_for(("hidden", "heads", None),
                           (4096, 32, 128)) == ("data", "model")


def test_policy_no_axis_reuse():
    policy = ShardingPolicy(FakeMesh({"data": 4, "model": 4}))
    # both dims want "model": only the first gets it
    assert policy.spec_for(("seq", "ffn"), (64, 64)) == ("model",)


def test_policy_exclude():
    full = ShardingPolicy(FakeMesh({"pod": 2, "data": 8, "model": 16}))
    nopod = full.without("pod")
    assert full.spec_for(("hidden",), (4096,)) == (("pod", "data"),)
    assert nopod.spec_for(("hidden",), (4096,)) == ("data",)
    assert nopod.fsdp_axes == ("data",)


def test_validate_mesh_for_catches_indivisible():
    policy = ShardingPolicy(FakeMesh({"data": 3, "model": 5}))
    # 16 % 3 != 0 -> hidden replicated (fine); 10 % 5 == 0 -> ffn shards
    assert validate_mesh_for(
        policy, {"w": ParamSpec((16, 10), ("hidden", "ffn"))}) == []
    assert validate_mesh_for(
        policy, {"w": ParamSpec((15, 64), ("hidden", "ffn"))}) == []


def test_placements_and_blocks():
    from torch.distributed.tensor import Replicate, Shard

    policy = ShardingPolicy(FakeMesh({"pod": 2, "data": 16, "model": 16}))
    names, shape = ("hidden", "ffn"), (4096, 14336)
    assert policy.placements_for(names, shape) == [Shard(0), Shard(0),
                                                   Shard(1)]
    # pod 1, data 3, model 5: row block 1 * 16 + 3 of 32, column block 5
    assert policy.local_slices(names, shape, (1, 3, 5)) == (
        slice(19 * 128, 20 * 128), slice(5 * 896, 6 * 896))
    assert policy.sharded_count(names, shape) == 512
    nopod = policy.without("pod")
    assert nopod.placements_for(names, shape) == [Replicate(), Shard(0),
                                                  Shard(1)]
    assert nopod.local_slices(names, shape, (1, 3, 5)) == (
        slice(3 * 256, 4 * 256), slice(5 * 896, 6 * 896))
