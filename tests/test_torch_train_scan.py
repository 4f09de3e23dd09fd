"""The hybrid SSM (hymba) and RWKV-6 backward (M10c training, second half)
held against the JAX package on the CPU, with the helpers and bounds of
``test_torch_train.py``.

At 2 x 12 tokens both packages scan step by step; at 2 x 256 both take
their chunked path, each chunk of 128 steps under activation
checkpointing (the reference's ``jax.checkpoint`` per chunk, the port's
``ssm.chunk_remat``).  Measured on this tree (CPU, torch 2.13, JAX 0.9):

* loss within ``LOSS_BOUND`` = 2**-6 and every gradient leaf within
  ``GRAD_BOUND`` = 2**-5 relative L2: hymba-1.5b at 2 x 12 loss 1.2e-5,
  worst leaf ``group0.ssm.A_log`` 0.0171; at 2 x 256 3.5e-6,
  ``group0.ssm.conv_b`` 0.0162; rwkv6-3b at 2 x 12 7.6e-5,
  ``layers.tm.mix_w`` 0.0163 (``layers.tm.u`` 0.0080); at 2 x 256
  2.6e-6, ``layers.tm.mix_r`` 0.0185 (``layers.tm.u`` 0.0175);
* the per-layer remat on and off, and the per-chunk remat on and off
  (``_scan`` and ``_wkv`` alone, and through ``Model.loss``): losses,
  outputs and gradients bit for bit;
* a 3-step trajectory (``test_torch_train.trajectories``) within
  ``TRAJ_LOSS_BOUND`` and ``TRAJ_CHANGE_BOUND``.
"""
import functools

import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import torch  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro_torch.models import rwkv, ssm  # noqa: E402
from test_torch_train import (  # noqa: E402
    batch,
    held_to_reference,
    port_grads,
    port_model,
    randn,
    ref_model,
    trajectory_held,
)

SCAN_FAMILIES = ("hymba_15b", "rwkv6_3b")
LENGTHS = (12, 256)  # one step at a time; two checkpointed chunks


@functools.lru_cache(maxsize=None)
def grads_at(arch: str, s: int):
    rm, params = ref_model(arch)
    rb, pb = batch(ref_get_smoke(arch), 0, s=s)
    rl, rg = jax.jit(jax.value_and_grad(rm.loss))(params, rb)
    loss, g = port_grads(port_model(arch, params), pb)
    return loss, rl, g, rg


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("arch", SCAN_FAMILIES)
def test_loss_and_gradients(arch, s):
    held_to_reference(arch, *grads_at(arch, s))


def assert_same(a, b) -> None:
    """Two ``(loss, {name: gradient})`` bit for bit."""
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name


@pytest.mark.parametrize("arch", SCAN_FAMILIES)
def test_layer_remat_changes_nothing(arch):
    """Per-layer checkpointing on and off at 2 x 256 (each layer's chunk
    checkpoints nested in it): the loss and every gradient bit for bit;
    the loss under autograd is the forward's without it."""
    _, params = ref_model(arch)
    _, pb = batch(ref_get_smoke(arch), 1, s=256)
    model = port_model(arch, params)
    with torch.no_grad():
        plain = model.loss(pb)
    on = port_grads(model, pb, remat=True)
    assert torch.equal(on[0], plain)
    assert_same(on, port_grads(model, pb, remat=False))


def counted(monkeypatch, module) -> list:
    """Count the calls of ``module.checkpoint``."""
    calls = []
    inner = module.checkpoint

    def wrapper(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    monkeypatch.setattr(module, "checkpoint", wrapper)
    return calls


def scan_alone(arch: str):
    """``ssm._scan`` (hymba) or ``rwkv._wkv`` over 2 x 256 seeded steps at
    the smoke widths: ``(a seeded cotangent's product with the outputs,
    the inputs' gradients)``."""
    b, s = 2, 256
    if arch == "hymba_15b":
        d_in, n = 128, 4
        xs = torch.from_numpy(randn(10, (b, s, d_in))).bfloat16()
        dt = torch.from_numpy(randn(11, (b, s, d_in), 0.1)).abs()
        ins = [xs, dt, torch.from_numpy(randn(12, (b, s, n))),
               torch.from_numpy(randn(13, (b, s, n))),
               -torch.from_numpy(randn(14, (d_in, n))).exp()]
        fn = ssm._scan
    else:
        h, hd = 4, 16
        shape = (b, s, h, hd)
        ins = [torch.from_numpy(randn(10, shape)).bfloat16(),
               torch.from_numpy(randn(11, shape, 0.3)),
               torch.from_numpy(randn(12, shape)),
               torch.sigmoid(torch.from_numpy(randn(13, shape))),
               torch.from_numpy(randn(14, (h, hd), 0.1)),
               torch.from_numpy(randn(15, (b, h, hd, hd), 0.1))]
        fn = rwkv._wkv
    ins = [t.requires_grad_(True) for t in ins]
    y, last = fn(*ins)
    ct = torch.from_numpy(randn(16, tuple(y.shape)))
    total = (y * ct).sum() + last.sum()
    return total.detach(), dict(enumerate(torch.autograd.grad(total, ins)))


@pytest.mark.parametrize("arch", SCAN_FAMILIES)
def test_chunk_remat_changes_nothing(arch, monkeypatch):
    """Per-chunk checkpointing on and off at 2 x 256, in the scan alone
    (two checkpointed chunks) and through ``Model.loss`` (two a layer, in
    the forward and again in each layer's recompute): outputs, losses and
    gradients bit for bit."""
    module = ssm if arch == "hymba_15b" else rwkv
    calls = counted(monkeypatch, module)
    on = scan_alone(arch)
    assert len(calls) == 2
    _, params = ref_model(arch)
    _, pb = batch(ref_get_smoke(arch), 2, s=256)
    model = port_model(arch, params)
    loss_on = port_grads(model, pb)
    layers = len(list(model.layers()))
    assert len(calls) == 2 + 2 * 2 * layers
    monkeypatch.setattr(ssm, "chunk_remat", lambda s: False)
    assert_same(on, scan_alone(arch))
    assert_same(loss_on, port_grads(model, pb))
    assert len(calls) == 2 + 2 * 2 * layers


@pytest.mark.parametrize("arch", SCAN_FAMILIES)
def test_three_step_trajectory(arch):
    trajectory_held(arch)
