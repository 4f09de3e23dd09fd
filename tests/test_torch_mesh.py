"""The multi-device layer on ranks (M10d, the ``pod`` and ``data`` axes),
held against the JAX package on the CPU.

Ranks are ``torch.multiprocessing`` spawns in a gloo group on 127.0.0.1
(``tests/_mesh_ranks.py``): one session of 2 ranks runs the compressor's
collective forms, the pod-compressed and FSDP trajectories and a resume
through ``remesh``; a session of 1 rank resumes the same checkpoint; one
of 4 ranks runs the compressor again.  The reference's own sharded
``make_train_step`` runs in a subprocess (``tests/_mesh_reference.py``:
forced host devices, a mesh with Auto axes), beside the ranks.

* ``GradCompressor.all_reduce`` on 2 and 4 ranks against the reference's
  ``all_reduce`` under ``jax.vmap(axis_name="pod")``: the mean and the
  residual ``ef_decay * (g_eff - mean)`` within ``COMP_BOUND`` = 2**-12
  relative L2 (the two packages' DCTs sum in other orders, which moves an
  int8 level by one now and then; measured up to 3.4e-5), ``truncate``'s
  within ``BF16_BOUND``; ``replicated_f32`` raises, as the reference's
  does;
* ``replica_sum_ranks`` against the reference's ``replica_sum`` on the
  stacked tree: the mean within ``COMP_BOUND``, the bf16 residual
  ``ef_decay * (gf - dec)`` within ``BF16_BOUND``; against the port's own
  ``replica_sum`` bit for bit;
* the smoke granite's 3 steps, pod-compressed on ``pod`` 2 and FSDP on
  ``data`` 2, against the reference's ``make_train_step`` on the same
  meshes from the same weights (``params_from_jax``) and the same global
  batches (``test_torch_train``'s trajectory draws): each loss within
  ``TRAJ_LOSS_BOUND``, the first gradient norm within ``GRAD_BOUND``,
  and FSDP's weights' change within ``TRAJ_CHANGE_BOUND``
  (``tests/test_torch_train.py``'s bounds; measured 0.131);
* the pod-compressed steps one at a time: each of the reference's,
  taken by the one-process oracle (each replica's gradients, the
  reference's leaves with a stack's layers in one, ``replica_sum``,
  ``AdamW.update``) from the reference's own state and gradients, its
  weights' change within ``COMP_BOUND`` (measured 0: the weights equal).
  Over 3 steps from the reference's weights the port's own gradients
  (``test_torch_train``'s 1-3% a leaf) move the pod-compressed weights
  0.167-0.230 from the reference's on five draws of batches (FSDP
  0.089-0.148), too near ``TRAJ_CHANGE_BOUND`` to hold; the ranks
  against the oracle bit for bit, the gradient norms included;
* each FSDP step against the one-device step from the same state (the
  ranks' state gathered at the step's start): the loss and the norm
  within ``ORDER_BOUND``; each FSDP rank holding half of every sharded
  leaf;
* a raw checkpoint of the FSDP run after step 1, restored and
  ``remesh``-ed onto 2 ranks (step 2's loss bit for bit the uninterrupted
  run's, every remeshed DTensor whole equal to its host leaf) and onto 1
  (the same loss within ``TRAJ_LOSS_BOUND``).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _mesh_ranks  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.distributed.compression import (  # noqa: E402
    CompressionConfig as RefCompressionConfig,
)
from repro.distributed.compression import (  # noqa: E402
    GradCompressor as RefGradCompressor,
)
from repro.distributed.optimizer import OptState as RefOptState  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig,
    GradCompressor,
)
from repro_torch.distributed.optimizer import (  # noqa: E402
    AdamW,
    AdamWConfig,
    OptState,
)
from repro_torch.distributed.train import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_jax,
    params_from_jax,
    stack_layers,
    to_torch,
    unstack_layers,
)
from test_torch_train import (  # noqa: E402
    GRAD_BOUND,
    TRAJ_CHANGE_BOUND,
    TRAJ_LOSS_BOUND,
    batch,
    f32,
    leaf_pairs,
    ref_model,
    rel_l2,
)

HERE = os.path.dirname(os.path.abspath(__file__))
MODES = ("none", "truncate", "truncate_int8")
RANK_MODES = MODES + ("replicated_f32",)
COMP_MIN = 4096  # the compressor's default min_size
COMP_BOUND = 2.0 ** -12
# bf16 values: gloo sums a bf16 wire in bf16, rounding each partial sum,
# where XLA's psum of the same wire rounds once (``truncate`` on 4 ranks,
# measured 3.3e-3; on 2 the one sum rounds alike); a bf16 residual rounds
# an element the f32 values put near a tie to the other neighbour
# (measured 2.6e-4)
BF16_BOUND = 2.0 ** -7
TRAIN_MIN = 256  # low enough that the smoke model's matrices compress
# the same sums in another order (FSDP against one device; measured up to
# 6.2e-7)
ORDER_BOUND = 2.0 ** -16
SHAPES = {"a": (8192,), "b": (49, 100), "c": (100,)}  # c under min_size


def comp_inputs(world: int):
    rng = np.random.default_rng(world)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(world)]
    res = [{k: (0.1 * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()} for _ in range(world)]
    return grads, res


def train_inputs():
    """The reference's smoke granite weights and 3 global batches of 2 x
    16, as ``test_torch_train.trajectories`` draws them."""
    _, params = ref_model("granite_8b")
    batches = []
    for i in range(3):
        _, b = batch(ref_get_smoke("granite_8b"), i, s=16, labels="tokens")
        batches.append((b["tokens"].numpy(), b["labels"].numpy()))
    return jax.tree_util.tree_map(np.asarray, params), batches


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The reference's run and every rank session's results."""
    tmp = tmp_path_factory.mktemp("mesh")
    params, batches = train_inputs()
    inp, out = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"params": params, "batches": batches,
                     "opt": _mesh_ranks.OPT, "min_size": TRAIN_MIN}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable,
                            os.path.join(HERE, "_mesh_reference.py"), inp,
                            out], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        ckpt = str(tmp / "ckpt")
        grads2, res2 = comp_inputs(2)
        two = _mesh_ranks.run_ranks(2, [
            ("compressor", dict(grads=grads2, residual=res2,
                                modes=RANK_MODES, min_size=COMP_MIN)),
            ("train", dict(params=params, batches=batches, mode="pod")),
            ("train", dict(params=params, batches=batches, mode="data",
                           ckpt_dir=ckpt)),
            ("resume", dict(params=params, batches=batches, ckpt_dir=ckpt)),
        ])
        one = _mesh_ranks.run_ranks(1, [
            ("resume", dict(params=params, batches=batches, ckpt_dir=ckpt))])
        grads4, res4 = comp_inputs(4)
        four = _mesh_ranks.run_ranks(4, [
            ("compressor", dict(grads=grads4, residual=res4,
                                modes=RANK_MODES, min_size=COMP_MIN))])
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log
    with open(out, "rb") as f:
        reference = pickle.load(f)
    return {"params": params, "batches": batches, "ref": reference,
            "comp": {2: ([r[0] for r in two], grads2, res2),
                     4: ([r[0] for r in four], grads4, res4)},
            "pod": [r[1] for r in two], "data": [r[2] for r in two],
            "resume2": [r[3] for r in two], "resume1": one[0][0]}


def stacked(trees, key):
    return np.stack([t[key] for t in trees])


def close(got, want, what, bound=COMP_BOUND):
    err = rel_l2(torch.from_numpy(np.asarray(got)),
                 torch.from_numpy(np.array(want, np.float32)))
    assert err <= bound, (what, err)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_all_reduce_is_the_reference_s(sessions, world, mode):
    outs, grads, res = sessions["comp"][world]
    comp = RefGradCompressor(RefCompressionConfig(mode=mode,
                                                  min_size=COMP_MIN))
    g = {k: jnp.asarray(stacked(grads, k)) for k in SHAPES}
    r = {k: jnp.asarray(stacked(res, k)) for k in SHAPES}
    mean, new_r = jax.vmap(lambda a, b: comp.all_reduce(a, world, b),
                           axis_name="pod")(g, r)
    bound = BF16_BOUND if mode == "truncate" else COMP_BOUND
    for rank, out in enumerate(outs):
        got_mean, got_r = out["all_reduce", mode]
        for k in SHAPES:
            close(got_mean[k], mean[k][rank], (mode, rank, k, "mean"), bound)
            close(got_r[k], new_r[k][rank], (mode, rank, k, "residual"),
                  bound)


@pytest.mark.parametrize("world", [2, 4])
def test_all_reduce_refuses_replicated_f32(sessions, world):
    outs, grads, _ = sessions["comp"][world]
    comp = RefGradCompressor(RefCompressionConfig(mode="replicated_f32",
                                                  min_size=COMP_MIN))
    g = {k: jnp.asarray(stacked(grads, k)) for k in SHAPES}
    with pytest.raises(ValueError, match="unknown compression mode"):
        jax.vmap(lambda a: comp.all_reduce(a, world), axis_name="pod")(g)
    for out in outs:
        assert "unknown compression mode 'replicated_f32'" in out[
            "replicated_f32_raises"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", RANK_MODES)
def test_replica_sum_ranks_is_replica_sum(sessions, world, mode):
    """Each rank's mean and residual: the reference's ``replica_sum`` on
    the stacked tree within ``COMP_BOUND``, the port's bit for bit."""
    outs, grads, res = sessions["comp"][world]
    r16 = {k: jnp.asarray(stacked(res, k), jnp.bfloat16) for k in SHAPES}
    mean, new_r = RefGradCompressor(RefCompressionConfig(
        mode=mode, min_size=COMP_MIN)).replica_sum(
        {k: jnp.asarray(stacked(grads, k)) for k in SHAPES}, r16)
    pmean, pres = GradCompressor(CompressionConfig(
        mode=mode, min_size=COMP_MIN)).replica_sum(
        {k: torch.from_numpy(stacked(grads, k)) for k in SHAPES},
        {k: torch.from_numpy(stacked(res, k)).to(torch.bfloat16)
         for k in SHAPES})
    for rank, out in enumerate(outs):
        got_mean, got_r = out["ranks", mode]
        for k in SHAPES:
            close(got_mean[k], mean[k], (mode, rank, k, "mean"))
            close(got_r[k][0], f32(new_r[k][rank]), (mode, rank, k, "res"),
                  BF16_BOUND)
            assert np.array_equal(got_mean[k], pmean[k].numpy()), (mode, k)
            assert np.array_equal(got_r[k][0], pres[k][rank].float()
                                  .numpy()), (mode, k)


def trajectory_held(ranks, ref, initial, change: bool) -> None:
    """Each rank's losses within ``TRAJ_LOSS_BOUND`` of the reference's,
    its first gradient norm (the same weights) within ``GRAD_BOUND`` (the
    gradients' own bound: two norms differ by no more than the
    difference's), and (``change``) the weights' change over the 3 steps
    within ``TRAJ_CHANGE_BOUND``."""
    for out in ranks:
        for pl, rl in zip(out["losses"], ref["losses"]):
            assert abs(pl - rl) <= TRAJ_LOSS_BOUND * abs(rl), (
                out["losses"], ref["losses"])
        assert abs(out["norms"][0] - ref["norms"][0]) <= GRAD_BOUND * (
            ref["norms"][0]), (out["norms"], ref["norms"])
        if not change:
            continue
        named = {n: torch.from_numpy(v) for n, v in out["params"].items()}
        d_port, d_ref = [], []
        for (_, got, want), (_, start) in zip(
                leaf_pairs(named, ref["params"]),
                jax.tree_util.tree_flatten_with_path(initial)[0]):
            d_port.append((f32(got) - f32(start)).ravel())
            d_ref.append((f32(want) - f32(start)).ravel())
        dp, dr = np.concatenate(d_port), np.concatenate(d_ref)
        rel = float(np.linalg.norm(dp - dr) / np.linalg.norm(dr))
        assert rel <= TRAJ_CHANGE_BOUND, rel


def test_pod_compressed_trajectory_is_the_reference_s(sessions):
    """The losses and the first norm only: the weights' change is held one
    step at a time (``test_pod_compressed_steps_are_the_reference_s_one_
    at_a_time``)."""
    ranks = sessions["pod"]
    assert all(r["compressed"] and r["replicas"] == 2 for r in ranks)
    trajectory_held(ranks, sessions["ref"]["pod"], sessions["params"],
                    change=False)


def test_fsdp_trajectory_is_the_reference_s(sessions):
    ranks = sessions["data"]
    assert not any(r["compressed"] for r in ranks)
    trajectory_held(ranks, sessions["ref"]["data"], sessions["params"],
                    change=True)


def replica_step(model, opt, comp, st, per_replica):
    """The one-process oracle's update: ``replica_sum`` on the replicas'
    gradients (``{name: [P, ...]}``) in the reference's layout, then
    ``AdamW.update``; returns the new state and the norm."""
    mean, res = comp.replica_sum(
        stack_layers(model, per_replica, layer_axis=1),
        stack_layers(model, st.residual, layer_axis=1))
    _, st, gnorm = opt.update(dict(model.named_parameters()), st,
                              unstack_layers(mean, model),
                              unstack_layers(res, model, layer_axis=1))
    return st, gnorm


def test_pod_compressed_ranks_are_the_one_process_oracle(sessions):
    """The two ranks' losses, gradient norms, weights and residuals bit
    for bit equal to one process taking each replica's gradients in turn,
    ``replica_sum`` on the stacked tree, then ``AdamW.update``."""
    model = build_model(get_smoke("granite_8b"), device="cpu")
    params_from_jax(sessions["params"], model)
    model.requires_grad_(True)
    opt = AdamW(AdamWConfig(**_mesh_ranks.OPT))
    comp = GradCompressor(CompressionConfig(min_size=TRAIN_MIN))
    params = dict(model.named_parameters())
    st = opt.init(params, with_residual=True, replicas=2)
    losses, norms = [], []
    for tokens, labels in sessions["batches"]:
        per, grads = [], []
        for p in range(2):
            loss = model.loss({"tokens": torch.from_numpy(tokens[p:p + 1]),
                               "labels": torch.from_numpy(labels[p:p + 1])})
            per.append(loss.detach())
            grads.append(torch.autograd.grad(loss, list(params.values())))
        st, gnorm = replica_step(model, opt, comp, st, {
            n: torch.stack([g[i] for g in grads])
            for i, n in enumerate(params)})
        losses.append(float(torch.stack(per).mean()))
        norms.append(float(gnorm))
    for rank, out in enumerate(sessions["pod"]):
        assert out["losses"] == losses
        assert out["norms"] == norms
        for n, p in params.items():
            assert np.array_equal(out["params"][n], p.detach().float()
                                  .numpy()), n
            assert np.array_equal(out["residual"][n],
                                  st.residual[n][rank:rank + 1].float()
                                  .numpy()), n


def test_pod_compressed_steps_are_the_reference_s_one_at_a_time(sessions):
    """Each of the reference's 3 pod-compressed steps taken by the port's
    oracle (``replica_step``) from the reference's own state before it
    (weights, m, v, each replica's residual) and its replicas' gradients
    there: the norm within ``COMP_BOUND``, the weights' change within
    ``COMP_BOUND`` of the reference's, m, v and the residuals within
    ``BF16_BOUND`` a leaf (the compressor's mean and residual bounds
    above; measured: the weights equal, the norm within 1e-7).  Steps
    from the same gradients, so only the compressor and the optimizer are
    compared (the gradients are ``test_torch_train``'s)."""
    ref = sessions["ref"]["pod"]
    model = build_model(get_smoke("granite_8b"), device="cpu")
    opt = AdamW(AdamWConfig(**_mesh_ranks.OPT))
    comp = GradCompressor(CompressionConfig(min_size=TRAIN_MIN))
    after = [(r["params"], r["state"]) for r in ref["steps"][1:]] + [
        (ref["params"], ref["state"])]
    assert len(ref["steps"]) == len(sessions["batches"])
    for k, (rec, (want_p, want_st)) in enumerate(zip(ref["steps"], after)):
        params_from_jax(rec["params"], model)
        start = {n: f32(p.detach()) for n, p in model.named_parameters()}
        st = opt_state_from_jax(RefOptState(**rec["state"]), model)
        grads = unstack_layers(rec["grads"], model, layer_axis=1)
        st, gnorm = replica_step(model, opt, comp, st, {
            n: to_torch(np.asarray(g)) for n, g in grads.items()})
        norm_gap = abs(float(gnorm) - ref["norms"][k]) / ref["norms"][k]
        assert norm_gap <= COMP_BOUND, (k, float(gnorm), ref["norms"][k])
        want = opt_state_from_jax(RefOptState(**want_st), model)
        wp = unstack_layers(want_p, model)
        d_port, d_ref = [], []
        for n, p in model.named_parameters():
            d_port.append((f32(p.detach()) - start[n]).ravel())
            d_ref.append((f32(wp[n]) - start[n]).ravel())
            for what in ("m", "v", "residual"):
                got, exp = getattr(st, what)[n], getattr(want, what)[n]
                close(got.float().numpy(), exp.float().numpy(),
                      (k, n, what), BF16_BOUND)
        dp, dr = np.concatenate(d_port), np.concatenate(d_ref)
        rel = float(np.linalg.norm(dp - dr) / np.linalg.norm(dr))
        assert rel <= COMP_BOUND, (k, rel)


def test_fsdp_steps_are_the_one_device_step_s(sessions):
    """Each FSDP step against the port's one-device step on the same
    global batch from the same state (the ranks' state gathered whole at
    the step's start): the loss and the gradient norm (the blocks'
    shares-weighted sums of squares summed across the ranks) within
    ``ORDER_BOUND``, the same arithmetic summed in another order."""
    model = build_model(get_smoke("granite_8b"), device="cpu")
    ts = make_train_step(model, AdamW(AdamWConfig(**_mesh_ranks.OPT)),
                         "cpu")
    for out in sessions["data"]:
        assert len(out["starts"]) == len(sessions["batches"])
        for k, (start, (tokens, labels)) in enumerate(zip(
                out["starts"], sessions["batches"])):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(start["params"][n]))
            st = OptState(
                step=torch.tensor(start["step"], dtype=torch.int32),
                m={n: torch.from_numpy(t).clone()
                   for n, t in start["m"].items()},
                v={n: torch.from_numpy(t).clone()
                   for n, t in start["v"].items()})
            _, met = ts.step_fn(st, {"tokens": torch.from_numpy(tokens),
                                     "labels": torch.from_numpy(labels)})
            for what, got in (("loss", out["losses"][k]),
                              ("grad_norm", out["norms"][k])):
                want = float(met[what])
                assert abs(got - want) <= ORDER_BOUND * abs(want), (
                    k, what, got, want)


def test_fsdp_ranks_hold_half_the_state(sessions):
    model = build_model(get_smoke("granite_8b"), device="meta")
    whole = sum(p.numel() for p in model.parameters())
    for out in sessions["data"]:
        held = out["held"]
        assert held["params"] == held["m"] == held["v"]
        # every smoke granite leaf but the norms shards over data 2
        assert whole / 2 <= held["params"] < 0.51 * whole, (held, whole)


def test_remesh_resumes_on_two_ranks_and_on_one(sessions):
    uninterrupted = [out["losses"][1] for out in sessions["data"]]
    two, one = sessions["resume2"], sessions["resume1"]
    assert all(r["step"] == 1 and r["whole_equal"] for r in two + [one])
    assert [r["loss"] for r in two] == uninterrupted
    assert abs(one["loss"] - uninterrupted[0]) <= TRAJ_LOSS_BOUND * abs(
        uninterrupted[0]), (one, uninterrupted)
