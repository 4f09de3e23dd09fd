"""The ``model`` axis (M10d: tensor, sequence and expert parallelism) on
ranks, held against the JAX package on the CPU.

Ranks are ``torch.multiprocessing`` spawns in a gloo group on 127.0.0.1
(``tests/_mesh_ranks.py``): one session of 2 ranks and one of 4.  The
reference runs its own ``make_serve_fns`` and ``make_train_step`` on the
same meshes in a subprocess (``tests/_model_axis_reference.py``: forced
host devices, Auto axes).  Both load the same weights, drawn here in
numpy (``draw_params``: each layer and expert from its own fan-in, as
the port draws them; the reference's stacked draw makes the smoke
models chaotic, ROADMAP R7).

* Serving (``make_serve_fns`` on a mesh): the prefill's last-token
  logits and one decode step's, each rank's rows, against the
  reference's on the same mesh, within ``SERVE_BOUND`` (relative L2):
  on ``(data 1, model 2)`` granite-8b, gemma2-27b (windows, softcaps),
  internvl2-26b (the patch prefix on the sequence-split stream),
  deepseek-v3 (MLA, the sharded MoE in the prefill and the dense one in
  the decode) and minitron-4b (3 heads, 1 KV head: the keys and values
  split over the sequence, the softmax's statistics combined across the
  ranks); on ``(1, 4)`` granite-8b (4 heads, 2 KV heads: K and V
  repeated to the query heads).  Measured over four draws of weights
  and prompts (draws 0-3, each case here takes its index): 0 (bit for
  bit) to 1.06e-2, the largest deepseek-v3's prefill; granite on ``(1,
  4)`` 6.6e-3 to 9.9e-3.  The reference's own logits move 0.9e-2 to
  1.8e-2 between one device and these meshes.  The cache holds each
  rank's KV heads where the axis divides them, all of them where it
  does not.
* Training (``make_train_step`` on ``(data 2, model 2)``, FSDP over
  ``data``, the model axis's collectives over ``model``): each of two
  steps of granite-8b taken from the reference's own state at its start
  (placed by ``elastic.remesh``), its loss within ``TRAJ_LOSS_BOUND``
  (measured 3.8e-5 to 1.4e-4), its gradient norm within ``NORM_BOUND``
  (measured 3.6e-6 to 1.5e-3), each leaf's gradient within
  ``LEAF_GRAD_BOUND`` (measured up to 0.014, the norms'), and the
  weights' change within
  ``TRAJ_CHANGE_BOUND`` (measured 0.052 to 0.089 over the state, 0.12
  the worst leaf: Adam's first steps move each weight by about ``lr``
  times the sign of its gradient, so a gradient near 0 flips its step)
  of the reference's step on the same mesh; each rank holding a quarter
  of each leaf split over both axes.
* ``launch.train --model-par 2`` and ``launch.serve_lm --model-par 2``
  under ``torchrun`` on gloo: the losses those of one process within
  ``TRAJ_LOSS_BOUND``, a checkpoint that one process resumes; the served
  generations and kv line those of one process.
* The refusals, which name ROADMAP item 6c-iii: the hybrid, RWKV and
  encoder-decoder families with ``model`` > 1, the pod-compressed step
  with ``data`` > 1.
"""
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import _mesh_ranks  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.common import ParamSpec as RefParamSpec  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import stack_layers, to_torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SERVE = (("granite_8b", (1, 2)), ("gemma2_27b", (1, 2)),
         ("internvl2_26b", (1, 2)), ("deepseek_v3_671b", (1, 2)),
         ("minitron_4b", (1, 2)), ("granite_8b", (1, 4)))
SERVE_BOUND = 2.0 ** -5
TRAIN_OPT = dict(base_lr=1e-3, warmup=1, total_steps=20)
TRAIN_STEPS = 2
TRAJ_LOSS_BOUND = 2.0 ** -8  # tests/test_torch_train.py's
NORM_BOUND = 2.0 ** -7
LEAF_GRAD_BOUND = 2.0 ** -5
TRAJ_CHANGE_BOUND = 2.0 ** -2  # tests/test_torch_train.py's
# the reference's own model-axis gap (ROADMAP R15): arch -> the leaf
# whose squared gradient norm moves most from one device to (1, 2)
GAPS = {"granite_8b": "['embed']", "whisper_tiny": "['enc_pos_embed']"}


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def draw_params(arch: str, seed: int) -> dict:
    """The reference's parameter tree for the smoke ``arch`` (numpy, its
    dtypes): normals with each layer's and each expert's own fan-in, as
    the port draws a layer (``Model.init_weights``); zeros and ones as
    specified."""
    specs = ref_build_model(ref_get_smoke(arch)).param_specs()
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init in ("zeros", "ones"):
            return (np.zeros if s.init == "zeros" else np.ones)(s.shape,
                                                                s.dtype)
        per, names = s.shape, s.names
        for lead in ("layers", "experts"):
            if names and names[0] == lead:
                per, names = per[1:], names[1:]
        if s.init == "embed":
            std = s.scale or 1.0
        else:
            std = s.scale if s.scale is not None else 1.0 / math.sqrt(
                per[0] if len(per) > 1 else per[-1])
        return (rng.standard_normal(s.shape, dtype=np.float32) * std
                ).astype(s.dtype)

    return jax.tree_util.tree_map(
        draw, specs, is_leaf=lambda x: isinstance(x, RefParamSpec))


def serve_job(arch: str, mesh, seed: int, b: int = 2, s: int = 16) -> dict:
    """A prefill of ``b x s`` seeded prompts (a VLM's patch embeddings
    at 0.01) and one decode step of seeded tokens."""
    cfg = ref_get_smoke(arch)
    rng = np.random.default_rng(seed)
    pre = cfg.vision_prefix if cfg.family == "vlm" else 0
    job = {"kind": "serve", "arch": arch, "mesh": mesh,
           "params": draw_params(arch, seed),
           "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
               np.int32),
           "next": rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
           "max_len": s + pre + 4, "pos": s + pre}
    if pre:
        job["patch_embeds"] = np.full((b, pre, cfg.d_model), 0.01,
                                      np.float32)
    return job


def gap_job(arch: str) -> dict:
    """The reference's own gradients on one device and on ``(1, 2)``
    from its ``PRNGKey(0)`` weights, 2 x 16 tokens from numpy seed 0."""
    tokens = np.random.default_rng(0).integers(
        0, ref_get_smoke(arch).vocab_size, (2, 16)).astype(np.int32)
    return {"kind": "gap", "arch": arch, "mesh": (1, 2), "tokens": tokens}


def start_reference(jobs, tmp):
    """Start the reference's subprocess on ``jobs``; returns a function
    that waits for it and gives its results."""
    inp, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, os.path.join(
        HERE, "_model_axis_reference.py"), inp, out], env=env)

    def results() -> list:
        try:
            assert proc.wait(timeout=600) == 0, proc.returncode
        finally:
            if proc.poll() is None:
                proc.kill()
        with open(out, "rb") as f:
            return pickle.load(f)

    return results


def run_reference(jobs, tmp) -> list:
    return start_reference(jobs, tmp)()


def train_job(seed: int, arch: str = "granite_8b", mesh=(2, 2),
              steps: int = TRAIN_STEPS) -> dict:
    batches = []
    for i in range(steps):
        t = np.random.default_rng(10 * seed + i).integers(
            0, 512, (2, 16)).astype(np.int32)
        batches.append((t, t))
    return {"kind": "train", "arch": arch, "mesh": mesh,
            "params": draw_params(arch, seed), "batches": batches,
            "opt": TRAIN_OPT}


def train_call(job: dict, ref: dict):
    """The ranks' ``axis_train`` of a train ``job`` from the starts of
    the reference's steps ``ref``."""
    return ("axis_train", {
        "arch": job["arch"], "batches": job["batches"], "mesh": job["mesh"],
        "opt": job["opt"], "starts": [st["start"] for st in ref["steps"]]})


def leaf_gaps(arch: str, got: dict, want) -> dict:
    """Relative L2 of each leaf of ``got`` (port names, whole) against
    ``want`` (the reference's tree), by the reference's path."""
    from repro_torch.configs import get_smoke

    model = build_model(get_smoke(arch), device="meta")
    tree = stack_layers(model, {n: to_torch(v) for n, v in got.items()})
    out = {}
    for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]:
        w = want
        for k in path:
            w = w[k.key]
        out[jax.tree_util.keystr(path)] = rel_l2(g.float().numpy(), w)
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    gaps = [gap_job(arch) for arch in GAPS]
    jobs = [serve_job(arch, mesh, i) for i, (arch, mesh) in
            enumerate(SERVE)] + [train_job(0)]
    # the 2-rank session needs nothing of the reference: it runs while
    # the reference does
    pending = start_reference(gaps + jobs, tmp)
    serving = {}
    for world in (2, 4):
        if world == 4:
            ref = pending()
            gaps, ref = dict(zip(GAPS, ref[:len(GAPS)])), ref[len(GAPS):]
        mine = [i for i, j in enumerate(jobs)
                if j["kind"] == "serve" and math.prod(j["mesh"]) == world]
        calls = [("serve", {k: v for k, v in jobs[i].items()
                            if k != "kind"}) for i in mine]
        if world == 2:
            calls.append(("compute_blocks", {"arch": "granite_8b",
                                             "mesh": (1, 2), "seed": 5}))
            calls.append(("refusals", {}))
        else:
            calls.append(train_call(jobs[-1], ref[-1]))
            calls.append(("refusals", {"pod": 2}))
        got = _mesh_ranks.run_ranks(world, calls)
        for n, i in enumerate(mine):
            serving[i] = [rank[n] for rank in got]
        if world == 2:
            blocks = [rank[-2] for rank in got]
            refusals = got[0][-1]
        else:
            train = [rank[-2] for rank in got]
            refusals.update(got[0][-1])
    return {"jobs": jobs, "ref": ref, "serving": serving, "train": train,
            "blocks": blocks, "refusals": refusals, "gaps": gaps}


@pytest.mark.parametrize("case", range(len(SERVE)),
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in SERVE])
def test_serve_logits_are_the_reference_s(sessions, case):
    want = sessions["ref"][case]
    for out in sessions["serving"][case]:
        rows = slice(*out["rows"])
        for key in ("prefill", "decode"):
            assert rel_l2(out[key], want[key][rows]) <= SERVE_BOUND, key


@pytest.mark.parametrize("arch,mesh,branch,kv", [
    ("granite_8b", (1, 2), None, 1),      # 2 KV heads, 1 a rank
    ("granite_8b", (1, 4), "repeat", 2),  # all of them on each rank
    ("minitron_4b", (1, 2), "seq", 1),    # 1 KV head on each rank
])
def test_attention_branches(sessions, arch, mesh, branch, kv):
    """The reference's layout branch (its ``attention``,
    ``common.py:175-195``) for each smoke configuration and mesh, and the
    KV heads each rank's cache holds."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import kv_branch

    class Axis:
        def splits(self, n):
            return n % mesh[1] == 0

    cfg = get_smoke(arch)
    assert kv_branch(cfg.num_heads, cfg.num_kv_heads, Axis()) == branch
    case = SERVE.index((arch, mesh))
    for out in sessions["serving"][case]:
        assert out["kv_heads"]["k"][3] == kv


def _stacked_change(got: dict, start, want) -> float:
    """Relative L2 of ``got`` (port names) against ``want`` (the
    reference's tree), over the weights' change from ``start``."""
    model = build_model(get_smoke_port("granite_8b"), device="meta")
    tree = stack_layers(model, {n: to_torch(v) for n, v in got.items()})
    num = den = 0.0
    for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]:
        w, s0 = want, start
        for k in path:
            w, s0 = w[k.key], s0[k.key]
        w = np.asarray(w, np.float32)
        s0 = np.asarray(s0, np.float32)
        num += float(np.sum((g.float().numpy() - w) ** 2))
        den += float(np.sum((w - s0) ** 2))
    return math.sqrt(num / den)


def get_smoke_port(arch):
    from repro_torch.configs import get_smoke

    return get_smoke(arch)


def test_train_steps_are_the_reference_s_one_at_a_time(sessions):
    ref = sessions["ref"][-1]["steps"]
    ranks = sessions["train"]
    for k in range(TRAIN_STEPS):
        got, want = ranks[0][k], ref[k]
        assert all(r[k]["loss"] == got["loss"] for r in ranks)
        assert all(r[k]["grad_norm"] == got["grad_norm"] for r in ranks)
        assert abs(got["loss"] - want["loss"]) <= TRAJ_LOSS_BOUND * abs(
            want["loss"]), k
        assert abs(got["grad_norm"] - want["grad_norm"]) <= NORM_BOUND * \
            want["grad_norm"], k
        assert _stacked_change(got["params"], want["start"]["params"],
                               want["params"]) <= TRAJ_CHANGE_BOUND, k


def test_train_gradients_are_the_reference_s_leaf_by_leaf(sessions):
    """Each leaf's gradient as the step hands it to ``AdamW.update``
    (gathered whole) against the reference's ``jax.grad`` of the same
    state under the same mesh, within ``LEAF_GRAD_BOUND``: the norms
    (``ln1``, ``ln2``, ``final_norm``, whole on every rank and summed
    over both axes) read 0.011 to 0.014, every other leaf less, over four
    draws and two steps; a norm's gradient summed over ``data`` alone
    reads 0.33 to 0.83, while the global norm stays within
    ``NORM_BOUND``."""
    ref = sessions["ref"][-1]["steps"]
    for k in range(TRAIN_STEPS):
        gaps = leaf_gaps("granite_8b", sessions["train"][0][k]["grads"],
                         ref[k]["grads"])
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= LEAF_GRAD_BOUND, (k, worst, gaps[worst])


def test_train_ranks_hold_a_quarter_of_the_split_leaves(sessions):
    """On ``(2, 2)`` each rank holds its block of every weight: a leaf
    split over ``data`` and ``model`` a quarter, over one of them a half,
    the norms whole."""
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.models.convert import param_specs_by_name

    class Mesh:
        axis_names, devices = ("data", "model"), np.zeros((2, 2))

    policy = ShardingPolicy(Mesh())
    model = build_model(get_smoke_port("granite_8b"), device="meta")
    specs = param_specs_by_name(model).values()
    want = sum(math.prod(s.shape) // policy.sharded_count(s.names, s.shape)
               for s in specs)
    whole = sum(math.prod(s.shape) for s in specs)
    held = [r[0]["held"] for r in sessions["train"]]
    assert held == [want] * 4 and want < whole / 3


def test_refusals_name_item_6c_iii(sessions):
    got = sessions["refusals"]
    for key in ("hymba_15b", "rwkv6_3b", "whisper_tiny", "pod_data"):
        assert "item 6c-iii" in got[key], (key, got[key])
    for argv in (["--arch", "hymba-15b"], ["--arch", "whisper-tiny"]):
        with pytest.raises(NotImplementedError, match="item 6c-iii"):
            launch_train.main(argv + ["--smoke", "--device", "cpu",
                                      "--model-par", "2"])
    with pytest.raises(NotImplementedError, match="item 6c-iii"):
        serve_lm.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                       "--model-par", "2"])


def _torchrun(module: str, argv, nproc: int = 2) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("WORLD_SIZE", None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *argv],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_launch_train_model_par_under_torchrun(tmp_path, capsys):
    """``--model-par 2`` on two ranks: rank 0 logs, the losses those of
    one process within ``TRAJ_LOSS_BOUND``, a compressed checkpoint at
    step 2 that one process resumes from."""
    argv = ["--arch", "granite-8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--log-every", "1", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--ckpt-compress"]
    lines = _torchrun("repro_torch.launch.train",
                      argv + ["--steps", "2", "--model-par", "2"]
                      ).splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and lines[-1] == "training done."
    assert f"checkpointed -> {tmp_path}/step_000000000002" in lines
    _, _, alone = launch_train.main(argv[:-5] + ["--steps", "2"])
    ranked = [float(ln.split()[3]) for ln in steps]
    for a, b in zip(ranked, alone):
        assert abs(a - b) <= TRAJ_LOSS_BOUND * abs(b)
    capsys.readouterr()
    _, _, resumed = launch_train.main(argv + ["--steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(resumed) == 1 and np.isfinite(resumed[0])


def test_serve_lm_model_par_under_torchrun():
    """``--model-par 2 --kv-compress`` on two ranks: rank 0 prints the kv
    line (every rank's KV heads), the timings and the generations, those
    of one process."""
    argv = ["--arch", "granite-8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "16", "--gen", "4",
            "--kv-compress"]
    lines = [ln for ln in _torchrun("repro_torch.launch.serve_lm",
                                    argv + ["--model-par", "2"]
                                    ).splitlines() if ln.strip()]
    alone = serve_lm.main(argv)
    assert lines[0] == "kv cache: 8192 B -> 4096 B (ratio 0.500)"
    assert lines[3] == "sample generations (first 12 token ids):"
    assert [eval(ln) for ln in lines[4:]] == alone.tolist()


@pytest.mark.parametrize("arch", list(GAPS))
def test_reference_axis_gap_is_carried_by_an_embedding(sessions, arch):
    """ROADMAP R15: the reference's model axis moves its own gradient
    norm (granite 116.635 -> 115.317, whisper 385.9 -> 1142.0 on these
    draws), and one embedding table carries most of the move, while
    every other leaf moves far less: the port's model axis is held
    against the reference's on the same mesh, not its one-device step."""
    got = sessions["gaps"][arch]
    change = {k: got["mesh"][k] ** 2 - v ** 2 for k, v in got["one"].items()}
    order = sorted(change, key=lambda k: -abs(change[k]))
    assert order[0] == GAPS[arch], [(k, change[k]) for k in order[:4]]
    assert abs(change[order[0]]) > 3 * abs(change[order[1]])


def test_compute_blocks_are_the_whole_draw_s_blocks(sessions):
    """``build_compute_blocks`` on ``(1, 2)``: each rank's weights equal
    its blocks of the whole model drawn from the same seed, the split
    leaves half as wide."""
    for rank in sessions["blocks"]:
        assert all(eq for eq, _ in rank.values()), [
            n for n, (eq, _) in rank.items() if not eq]
    cfg = get_smoke_port("granite_8b")
    got = sessions["blocks"][0]
    assert got["embed"][1] == (cfg.vocab_size // 2, cfg.d_model)
    assert got["final_norm"][1] == (cfg.d_model,)
