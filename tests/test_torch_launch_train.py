"""The port's training driver (``python -m repro_torch.launch.train``) on
the CPU: its log lines, its checkpoints and resumes, and its refusals.

A run of 4 steps that checkpoints every 2, relaunched to 6, resumes from
step 4 and ends bit for bit where one uninterrupted 6-step run ends
(weights, m and v); relaunched from a compressed checkpoint it resumes and
stays finite.  The MoE + MLA (deepseek-v3), encoder-decoder (whisper),
hybrid SSM (hymba) and RWKV smoke models train, checkpoint compressed and
resume the same way; hymba also over 256 tokens, where its scan
checkpoints each chunk.  A compressed checkpoint writes every weight raw,
a fp32 one of 4096 elements too.  ``torchrun --nproc-per-node 2 ...
--data 2`` trains FSDP on two gloo ranks (its losses those of one process
on the same batches within 2**-8), checkpoints compressed, and a relaunch
with ``--data 1`` resumes from it; ``--data 2`` under a world of 1 and
``--model-par 2`` (naming the ROADMAP item) raise; with no device and no
card it raises.  The reference's ``launch.train`` is not run here.
"""
import json
import math
import os

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.models.convert import train_state_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--batch",
        "2", "--seq", "16", "--log-every", "1"]


def run(capsys, *extra):
    model, st, losses = train.main(BASE + list(extra))
    return model, st, losses, capsys.readouterr().out


def test_log_lines_and_checkpoints(tmp_path, capsys):
    _, st, losses, out = run(capsys, "--steps", "3", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "2")
    lines = out.splitlines()
    assert lines[0].startswith("step     0 loss ")
    assert " gnorm " in lines[0] and lines[0].rstrip().endswith("ms")
    assert f"checkpointed -> {tmp_path}/step_000000000002" in lines
    assert lines[-1] == "training done."
    assert int(st.step) == 3 and len(losses) == 3
    assert all(l == l and l < 20 for l in losses)  # finite, not diverged
    assert sorted(os.listdir(tmp_path)) == ["step_000000000002"]


def test_relaunch_resumes_where_the_run_stopped(tmp_path, capsys):
    """4 steps, then a relaunch to 6: ``resumed from step 4``, and the
    final state equals an uninterrupted 6-step run's."""
    once, st_once, losses, _ = run(capsys, "--steps", "6", "--ckpt-dir",
                                   str(tmp_path / "once"),
                                   "--ckpt-every", "2")
    _, _, first, _ = run(capsys, "--steps", "4", "--ckpt-dir",
                         str(tmp_path / "twice"), "--ckpt-every", "2")
    model, st, second, out = run(capsys, "--steps", "6", "--ckpt-dir",
                                 str(tmp_path / "twice"), "--ckpt-every",
                                 "2")
    assert out.splitlines()[0] == "resumed from step 4"
    assert out.splitlines()[1].startswith("step     4 loss ")
    assert first + second == losses
    assert int(st.step) == 6
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 once.named_parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(st.m[name], st_once.m[name]), name
        assert torch.equal(st.v[name], st_once.v[name]), name


def test_relaunch_from_a_compressed_checkpoint(tmp_path, capsys):
    """``--ckpt-compress``: m and v go through FPTC (the plain versions on
    the CPU); the relaunch resumes from step 4 and its losses stay
    finite."""
    run(capsys, "--steps", "4", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "2", "--ckpt-compress")
    assert any(f.endswith(".fptc") for f in os.listdir(
        tmp_path / "step_000000000004"))
    _, st, losses, out = run(capsys, "--steps", "6", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "2",
                             "--ckpt-compress")
    assert out.splitlines()[0] == "resumed from step 4"
    assert len(losses) == 2 and all(l == l and l < 20 for l in losses)
    assert int(st.step) == 6


def compressed_relaunch(capsys, tmp_path, *argv):
    """4 steps with a compressed checkpoint every 2, then a relaunch to 6
    that resumes from step 4 with finite losses: the checkpoint's manifest
    leaves."""
    argv = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--ckpt-compress", *argv]
    _, _, first, _ = run(capsys, "--steps", "4", *argv)
    with open(tmp_path / "step_000000000004" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    _, st, losses, out = run(capsys, "--steps", "6", *argv)
    assert out.splitlines()[0] == "resumed from step 4"
    assert out.splitlines()[1].startswith("step     4 loss ")
    assert len(first) == 4 and len(losses) == 2
    assert all(l == l and l < 20 for l in first + losses)
    assert int(st.step) == 6
    return leaves


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-tiny",
                                  "hymba-15b", "rwkv6-3b"])
def test_family_relaunch_from_a_compressed_checkpoint(arch, tmp_path,
                                                      capsys):
    """The MoE + MLA, encoder-decoder, hybrid SSM and RWKV smoke models
    (whisper fed zero frames; ``compressed_relaunch``).  deepseek-v3's
    expert stacks ``[L, E, d, f]`` and their m and v are in the
    checkpoint, m and v compressed; RWKV's flat ``layers`` stack is
    stacked on its layer axis."""
    leaves = compressed_relaunch(capsys, tmp_path, "--arch", arch)
    if arch == "deepseek-v3-671b":
        for part in ("params", "m", "v"):
            entry = leaves[f"['{part}']['group1']['ffn']['wi']"]
            assert len(entry["shape"]) == 4 and entry["shape"][1] == 8
            assert ("codec" in entry) == (part != "params"), entry
    if arch == "rwkv6-3b":
        cfg = get_smoke(arch)
        for part in ("params", "m", "v"):
            entry = leaves[f"['{part}']['layers']['tm']['u']"]
            assert entry["shape"] == [cfg.num_layers, cfg.d_model
                                      // cfg.rwkv_head_size,
                                      cfg.rwkv_head_size], entry


def test_hybrid_relaunch_over_checkpointed_chunks(tmp_path, capsys):
    """The smoke hymba over 2 x 256 tokens (its scan in two checkpointed
    chunks), relaunched from a compressed checkpoint: the fp32 SSM leaves
    (``A_log``, ``D``, ``dt_bias``) and their m and v are in the
    manifest, each in fp32 at its stacked shape."""
    cfg = get_smoke("hymba-15b")
    leaves = compressed_relaunch(capsys, tmp_path, "--arch", "hymba-15b",
                                 "--seq", "256")
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    shapes = {"A_log": [cfg.num_layers, d_in, n],
              "D": [cfg.num_layers, d_in], "dt_bias": [cfg.num_layers, d_in]}
    for part in ("params", "m", "v"):
        for name, shape in shapes.items():
            entry = leaves[f"['{part}']['group0']['ssm']['{name}']"]
            assert entry["dtype"] == "float32" and entry["shape"] == shape


def test_compressed_checkpoint_writes_the_weights_raw(tmp_path, capsys,
                                                     monkeypatch):
    """A fp32 weight that reaches the codec's 4096 elements (the smoke
    hymba with the full model's SSM state N 16: ``A_log`` [2, 128, 16])
    is written raw by ``--ckpt-compress`` and restores bit for bit, as
    every weight does, while its m and v are compressed."""
    cfg = get_smoke("hymba-15b").replace(ssm_state=16)
    monkeypatch.setattr(train, "get_smoke", lambda arch: cfg)
    model, st, _, _ = run(capsys, "--arch", "hymba-15b", "--steps", "2",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                          "--ckpt-compress")
    with open(tmp_path / "step_000000000002" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    a_log = "['{}']['group0']['ssm']['A_log']"
    entry = leaves[a_log.format("params")]
    assert entry["dtype"] == "float32" and math.prod(entry["shape"]) >= 4096
    assert [k for k, e in leaves.items()
            if k.startswith("['params']") and "codec" in e] == []
    for part in ("m", "v"):
        assert leaves[a_log.format(part)]["codec"] == "fptc_state"
    want = train_state_tree(model, st)
    _, got = ckpt.restore_latest(str(tmp_path), want, device="cpu")
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        assert torch.equal(torch.as_tensor(a), b)


@pytest.mark.parametrize("argv,match", [
    (["--model-par", "2"], "ROADMAP queue 1, item 6c-ii"),
])
def test_refusals(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(BASE + ["--steps", "1"] + argv)


def test_data_needs_as_many_ranks(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--data 2 needs 2 ranks .* "
                       "WORLD_SIZE is 1"):
        train.main(BASE + ["--steps", "1", "--data", "2"])


def test_torchrun_data_two_trains_and_resumes_on_one(tmp_path, capsys):
    """Two ranks under ``torchrun`` (``--data 2``): rank 0's log, its
    losses those of one process on the same global batches within 2**-8,
    a compressed checkpoint at step 2; relaunched on one process with
    ``--data 1``, it resumes from step 2."""
    import subprocess
    import sys

    argv = BASE + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                   "--ckpt-compress"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("WORLD_SIZE", None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *argv, "--steps", "2", "--data", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2  # rank 0 alone logs
    assert f"checkpointed -> {tmp_path}/step_000000000002" in lines
    assert lines[-1] == "training done."
    _, _, alone, _ = run(capsys, "--steps", "2")
    for line, want in zip(steps, alone):
        got = float(line.split()[3])
        assert abs(got - want) <= 2.0 ** -8 * abs(want), (steps, alone)
    _, st, losses, out = run(capsys, *argv[len(BASE):], "--steps", "4",
                             "--data", "1")
    assert "resumed from step 2" in out.splitlines()
    assert int(st.step) == 4 and len(losses) == 2
    assert all(math.isfinite(x) for x in losses)


def test_no_card_means_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv + ["--steps", "1"])


def test_compression_flag_leaves_one_device_uncompressed(capsys):
    """``--compression truncate_int8`` on one device: the step is the
    uncompressed one, as in the reference without a pod axis."""
    _, _, a, _ = run(capsys, "--steps", "2")
    _, _, b, _ = run(capsys, "--steps", "2", "--compression",
                     "truncate_int8")
    assert a == b


# ---------------------------------------------------------------------------
# The two training examples, on the CPU.
# ---------------------------------------------------------------------------


def example(*argv):
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_train_example_runs_and_resumes_on_the_cpu(tmp_path):
    """``examples/train_lm_100m_torch.py --smoke --device cpu``: 4 steps
    with a compressed checkpoint every 2, then a relaunch to 6 that
    resumes from step 4."""
    argv = ["examples/train_lm_100m_torch.py", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--ckpt-every", "2", "--dir",
            str(tmp_path)]
    out = example(*argv, "--steps", "4")
    assert "ckpt@4:" in out and out.rstrip().endswith("done.")
    assert any(f.endswith(".fptc") for f in os.listdir(
        tmp_path / "step_000000000004"))
    out = example(*argv, "--steps", "6")
    assert out.splitlines()[1] == "resumed from step 4"
    assert "step    5 loss " in out


def test_checkpoint_example_runs_on_the_cpu(tmp_path):
    """``examples/checkpoint_compression_torch.py --smoke --device cpu``:
    the report lands under ``--dir`` (nothing under ``benchmarks/``), the
    state shrinks and restores within the reference's bound."""
    import json

    before = os.path.exists(os.path.join(ROOT, "benchmarks", "artifacts"))
    out = example("examples/checkpoint_compression_torch.py", "--smoke",
                  "--device", "cpu", "--dir", str(tmp_path))
    assert f"report -> {tmp_path}/workloads.json" in out
    with open(tmp_path / "workloads.json") as f:
        rep = json.load(f)["checkpoint"]
    assert rep["train_steps"] == 2 and rep["device"] == "cpu"
    assert rep["compressed_disk_bytes"] < 0.8 * rep["raw_disk_bytes"]
    assert rep["restore_rel_error"] < 0.02
    assert os.path.exists(os.path.join(ROOT, "benchmarks",
                                       "artifacts")) == before
