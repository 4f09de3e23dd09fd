"""The expert-parallel MoE on ranks (``models/moe_distributed.py``, M10d's
``model`` axis), held against the JAX package on the CPU.

Ranks are ``torch.multiprocessing`` spawns in a gloo group on 127.0.0.1
(``tests/_mesh_ranks.py``): one session of 2 ranks, a ``(data 1, model
2)`` mesh, and one of 4, ``(data 2, model 2)``.  The reference runs its
own functions on the same meshes in a subprocess
(``tests/_model_axis_reference.py``: forced host devices, Auto axes).
Both load the same weights, drawn here in numpy (each layer and each
expert from its own fan-in, as the port draws them; ROADMAP R7).

* ``sort_rank`` against the reference's ``sort_rank`` and a count,
  exactly;
* one MoE layer's ``moe_apply`` under the mesh's policy, forward and
  backward against the same cotangent (the reference's ``jax.vjp``):
  llama4-scout's 4 experts on ``(1, 2)`` (model-axis EP: an all-to-all
  over ``model``), deepseek-v3's 8 on ``(2, 2)`` (full EP: whole experts
  on each rank, one all-to-all over both axes), and deepseek-v3 with one
  token a row on ``(2, 2)`` (too few tokens a shard: the reference's
  dense dispatch over the global batch, each rank its experts, summed).
  The output block and each weight's gradient within ``MOE_BOUND`` and
  the input's gradient within ``MOE_DX_BOUND`` (relative L2) of the
  reference's: the sharded path's output moved up to 2.5e-3 and its
  weight gradients up to 8.4e-3 (the router's; the experts' 0 to 1e-4),
  the input gradients 3.3e-3 to 4.5e-3, over three draws of weights and
  inputs; the dense fallback's output equal;
* the smoke scout on ``(1, 2)`` and the smoke deepseek-v3 on ``(2, 2)``
  served: the prefill's last-token logits within ``MOE_PREFILL_BOUND``
  and one decode step's within ``MOE_DECODE_BOUND`` of the reference's
  ``make_serve_fns`` on the same mesh.  Over four draws: scout 3.0e-3 to
  5.5e-3; deepseek-v3's prefill 7.6e-3 to 6.69e-2 (draw 0's second row:
  a token whose capacity slot or top-k choice the layers before the MoE
  tip, as the reference's own second row moves 7.3e-2 between one
  device and this mesh), its decode (the dense dispatch) 8.1e-3 to
  1.83e-2.  The layer itself is held above to 2.5e-3;
* one ``make_train_step`` of the smoke scout on ``(2, 1)`` (FSDP alone,
  the dense MoE over the global batch) and of the smoke deepseek-v3 on
  ``(2, 2)`` (full EP) from the reference's state: the loss, the
  gradient norm and each leaf's gradient against the reference's step
  on the same mesh.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _mesh_ranks  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models.moe_distributed import (  # noqa: E402
    sort_rank as ref_sort_rank,
)
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.moe_distributed import (  # noqa: E402
    shard_capacity,
    sort_rank,
)
from test_torch_model_axis import (  # noqa: E402
    LEAF_GRAD_BOUND,
    NORM_BOUND,
    TRAJ_LOSS_BOUND,
    draw_params,
    leaf_gaps,
    rel_l2,
    run_reference,
    serve_job,
    train_call,
    train_job,
)

# (arch, mesh, sequence length): the two expert-parallel layouts and the
# dense fallback (2 tokens over 4 shards)
LAYOUTS = (("llama4_scout_17b_a16e", (1, 2), 16),
           ("deepseek_v3_671b", (2, 2), 16),
           ("deepseek_v3_671b", (2, 2), 1))
SERVED = (("llama4_scout_17b_a16e", (1, 2)), ("deepseek_v3_671b", (2, 2)))
# one train step each: scout under FSDP alone (the dense MoE over the
# global batch), deepseek-v3 with full EP on (2, 2) (the sharded MoE);
# with each its gradient-norm and worst-leaf bounds
MOE_NORM_BOUND = 2.0 ** -5
MOE_LEAF_GRAD_BOUND = 2.0 ** -2
TRAINED = (("llama4_scout_17b_a16e", (2, 1), NORM_BOUND, LEAF_GRAD_BOUND),
           ("deepseek_v3_671b", (2, 2), MOE_NORM_BOUND,
            MOE_LEAF_GRAD_BOUND))
MOE_BOUND = 2.0 ** -5
MOE_DX_BOUND = 2.0 ** -6
MOE_PREFILL_BOUND = 2.0 ** -3
MOE_DECODE_BOUND = 2.0 ** -5


def bf16_values(rng, shape) -> np.ndarray:
    """f32 values that bf16 holds exactly."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def layer_ffn(params) -> dict:
    """The last group's first layer's ``ffn`` (a MoE layer's)."""
    g = sorted(k for k in params if k.startswith("group"))[-1]
    return {k: {kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
            else v[0] for k, v in params[g]["ffn"].items()}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_axis")
    rng = np.random.default_rng(7)
    jobs = []
    for arch, mesh, s in LAYOUTS:
        d = ref_get_smoke(arch).d_model
        jobs.append({"kind": "moe", "arch": arch, "mesh": mesh,
                     "p": layer_ffn(draw_params(arch, 1)),
                     "x": bf16_values(rng, (2, s, d)),
                     "cot": bf16_values(rng, (2, s, d))})
    for arch, mesh in SERVED:
        jobs.append(serve_job(arch, mesh, 0))
    for arch, mesh, _, _ in TRAINED:
        jobs.append(train_job(0, arch, mesh, steps=1))
    ref = run_reference(jobs, tmp)
    runs = {}
    for world in (2, 4):
        mine = [(i, j) for i, j in enumerate(jobs)
                if j["mesh"][0] * j["mesh"][1] == world]
        calls = []
        for i, j in mine:
            if j["kind"] == "moe":
                calls.append(("moe", {k: j[k] for k in (
                    "arch", "p", "x", "cot", "mesh")}))
            elif j["kind"] == "train":
                calls.append(train_call(j, ref[i]))
            else:
                calls.append(("serve", {k: v for k, v in j.items()
                                        if k not in ("kind",)}))
        if world == 4:
            calls.append(("compute_blocks", {
                "arch": "deepseek_v3_671b", "mesh": (2, 2), "seed": 5}))
        got = _mesh_ranks.run_ranks(world, calls)
        for n, (i, _) in enumerate(mine):
            runs[i] = [rank[n] for rank in got]
        if world == 4:
            blocks = [rank[-1] for rank in got]
    return {"jobs": jobs, "ref": ref, "ranks": runs, "blocks": blocks}


@pytest.mark.parametrize("n,e", [(1, 1), (7, 3), (64, 8), (333, 16),
                                 (4096, 256)])
def test_sort_rank_is_the_reference_s(n, e):
    ids = np.random.default_rng(n).integers(0, e, n).astype(np.int32)
    got = sort_rank(torch.from_numpy(ids).long(), e).numpy()
    want = np.asarray(jax.jit(ref_sort_rank, static_argnums=1)(
        jnp.asarray(ids), e))
    count = np.array([np.sum(ids[:i] == ids[i]) for i in range(n)])
    assert np.array_equal(got, want) and np.array_equal(got, count)


@pytest.mark.parametrize("t_eff", [1, 8, 16, 1000, 4096])
def test_shard_capacity_is_the_reference_s(t_eff):
    for arch in ("llama4_scout_17b_a16e", "deepseek_v3_671b"):
        cfg = ref_get_smoke(arch)
        cap = -(-2 * t_eff * cfg.moe_top_k // cfg.moe_num_experts)
        want = max(8, -(-cap // 8) * 8)  # moe_distributed.py:106-107
        assert shard_capacity(get_smoke(arch), t_eff) == want


@pytest.mark.parametrize("case", range(len(LAYOUTS)),
                         ids=[f"{a}-{m[0]}x{m[1]}-s{s}"
                              for a, m, s in LAYOUTS])
def test_moe_layer_is_the_reference_s(sessions, case):
    want = sessions["ref"][case]
    for r, out in enumerate(sessions["ranks"][case]):
        rows, seq = slice(*out["rows"]), slice(*out["seq"])
        assert rel_l2(out["y"], want["y"][rows, seq]) <= MOE_BOUND, r
        assert rel_l2(out["dx"], want["dx"][rows]) <= MOE_DX_BOUND, r
        for name, g in out["dp"].items():
            w = want["dp"]
            for k in name.split("."):
                w = w[k]
            block = tuple(slice(a, b) for a, b in out["blocks"][name])
            assert rel_l2(g, np.asarray(w)[block]) <= MOE_BOUND, (r, name)
        assert out["dropped"] >= 0 and out["experts_hit"] > 0


def test_layouts_are_the_reference_s(sessions):
    """Each layout's expert blocks: scout's 4 experts 2 a rank over
    ``model``, its hidden dim whole (no data axis to gather over);
    deepseek-v3's 8 whole experts 2 a rank over ``data x model``, in the
    fused axis's order."""
    scout = [r["blocks"]["wi"] for r in sessions["ranks"][0]]
    assert scout == [((0, 2), (0, 64), (0, 128)), ((2, 4), (0, 64),
                                                    (0, 128))]
    deep = [r["blocks"]["wi"][0] for r in sessions["ranks"][1]]
    assert deep == [(0, 2), (2, 4), (4, 6), (6, 8)]


@pytest.mark.parametrize("case", range(len(SERVED)),
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in SERVED])
def test_moe_serve_logits_are_the_reference_s(sessions, case):
    i = len(LAYOUTS) + case
    want = sessions["ref"][i]
    for out in sessions["ranks"][i]:
        rows = slice(*out["rows"])
        for key, bound in (("prefill", MOE_PREFILL_BOUND),
                           ("decode", MOE_DECODE_BOUND)):
            assert rel_l2(out[key], want[key][rows]) <= bound, key


@pytest.mark.parametrize("case", range(len(TRAINED)),
                         ids=[f"{a}-{m[0]}x{m[1]}"
                              for a, m, _, _ in TRAINED])
def test_moe_train_step_is_the_reference_s(sessions, case):
    """One ``make_train_step`` of the smoke MoE model from the
    reference's state against the reference's step on the same mesh:
    the loss within ``TRAJ_LOSS_BOUND``, the gradient norm within the
    case's bound and each leaf's gradient (as handed to
    ``AdamW.update``, gathered) within its worst-leaf bound.  Readings
    over four draws: scout on ``(2, 1)`` (FSDP alone: the dense MoE
    routes the global batch under one capacity, as the reference's
    does) loss 6.2e-5 to 1.2e-4, norm 6.0e-4 to 1.5e-3, worst leaf
    0.011 to 0.014 (``NORM_BOUND``, ``LEAF_GRAD_BOUND``); deepseek-v3 on
    ``(2, 2)`` (full EP, the sharded MoE) loss 2.3e-4 to 5.7e-4, norm
    7.1e-4 to 1.41e-2, worst leaf 0.027 to 0.151 (the router, on a draw
    whose routing the layers' rounding tips), so ``MOE_NORM_BOUND`` and
    ``MOE_LEAF_GRAD_BOUND``.  With the norms' gradients summed over
    ``data`` alone the worst leaf reads 0.92 and 0.94 there (two
    draws)."""
    arch, _, norm_bound, leaf_bound = TRAINED[case]
    i = len(LAYOUTS) + len(SERVED) + case
    want = sessions["ref"][i]["steps"][0]
    ranks = [r[0] for r in sessions["ranks"][i]]
    got = ranks[0]
    assert all(r["loss"] == got["loss"] and r["grad_norm"] ==
               got["grad_norm"] for r in ranks)
    assert abs(got["loss"] - want["loss"]) <= TRAJ_LOSS_BOUND * abs(
        want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= norm_bound * \
        want["grad_norm"]
    gaps = leaf_gaps(arch, got["grads"], want["grads"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= leaf_bound, (worst, gaps[worst])


def test_compute_blocks_hold_whole_experts_of_the_whole_draw(sessions):
    """``build_compute_blocks`` of the smoke deepseek-v3 on ``(2, 2)``:
    each rank's weights equal its blocks of the whole model drawn from
    the same seed, its expert stacks 2 of the 8 whole experts."""
    cfg = get_smoke("deepseek_v3_671b")
    for rank in sessions["blocks"]:
        assert all(eq for eq, _ in rank.values()), [
            n for n, (eq, _) in rank.items() if not eq]
        stacks = [shape for n, (_, shape) in rank.items()
                  if n.endswith("ffn.wi") and len(shape) == 3]
        assert stacks and all(sh[0] == cfg.moe_num_experts // 4
                              for sh in stacks)
