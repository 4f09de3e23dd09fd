"""The port's architecture registry (``repro_torch.configs``) and
``ArchConfig`` against the JAX package's, and ``ParamSpec``'s draws.

All ten ``ARCH``/``SMOKE`` pairs are equal field by field, ``param_count``
is equal, and ``cells()`` gives the same 40 cells and 8 skips.  A drawn
normal leaf's standard deviation is within 5% of its spec's at 4096
elements (the sample std's own spread there is about 1.1%); zeros and
ones are exact."""
import dataclasses

import pytest

pytest.importorskip("jax")  # the reference; absent on the card

import torch  # noqa: E402

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.models.common import ParamSpec, init_params


@pytest.mark.parametrize("which", ["get_arch", "get_smoke"])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_the_reference(arch, which):
    mine = getattr(configs, which)(arch)
    ref = getattr(ref_configs, which)(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_dtype == "bfloat16"


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_param_count_equals_the_reference(arch):
    mine, ref = configs.get_arch(arch), ref_configs.get_arch(arch)
    for active in (False, True):
        assert mine.param_count(active) == ref.param_count(active)
    assert mine.is_attention_free == ref.is_attention_free
    assert mine.supports_long_decode == ref.supports_long_decode


def test_cells_equal_the_reference():
    mine, ref = configs.cells(), ref_configs.cells()
    assert len(mine) == 40 and sum(bool(c.skip) for c in mine) == 8
    assert [(c.arch_id, dataclasses.asdict(c.shape), c.skip)
            for c in mine] == [(c.arch_id, dataclasses.asdict(c.shape),
                                c.skip) for c in ref]
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


def test_ids_resolve_with_dashes_and_underscores():
    assert configs.get_arch("granite-8b") == configs.get_arch("granite_8b")
    assert configs.get_smoke("qwen15-4b") == configs.get_smoke("qwen15_4b")
    assert configs.get_arch("granite-8b").replace(num_layers=2).num_layers == 2
    with pytest.raises(ModuleNotFoundError):
        configs.get_arch("no-such-model")


@pytest.mark.parametrize("spec", [
    ParamSpec((64, 64), ("hidden", "ffn")),  # fan-in 64
    ParamSpec((4, 32, 32), ("layers", "hidden", None)),  # stacked: fan-in 4
    ParamSpec((4096,), (None,)),  # a vector: fan-in its length
    ParamSpec((64, 64), ("vocab", None), init="embed", scale=0.02),
    ParamSpec((64, 64), ("hidden", None), scale=0.5),
], ids=["fan_in", "stacked", "vector", "embed", "scale"])
def test_normal_draws_have_the_spec_std(spec):
    g = torch.Generator().manual_seed(0)
    x = spec.initializer(g, "cpu")
    assert x.shape == spec.shape and x.dtype == torch.bfloat16
    std = float(x.float().std())
    assert abs(std - spec.std) <= 0.05 * spec.std, (std, spec.std)
    assert abs(float(x.float().mean())) <= 0.05 * spec.std


def test_zeros_and_ones_are_exact():
    specs = {"z": ParamSpec((8, 3), ("a", "b"), init="zeros"),
             "o": {"one": ParamSpec((5,), ("a",), init="ones",
                                    dtype=torch.float32)}}
    got = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(got["z"], torch.zeros(8, 3, dtype=torch.bfloat16))
    assert torch.equal(got["o"]["one"], torch.ones(5))
    with pytest.raises(ValueError):
        ParamSpec((8, 3), ("a",))
