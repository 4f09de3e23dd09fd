"""The port's training driver (``python -m repro_torch.launch.train``) on
the CPU: its log lines, its checkpoints and resumes, and its refusals.

A run of 4 steps that checkpoints every 2, relaunched to 6, resumes from
step 4 and ends bit for bit where one uninterrupted 6-step run ends
(weights, m and v); relaunched from a compressed checkpoint it resumes and
stays finite.  The MoE + MLA (deepseek-v3) and encoder-decoder (whisper)
smoke models train, checkpoint compressed and resume the same way.
Multi-device flags and the families the port serves but does not train
yet (the hybrid, RWKV) raise ``NotImplementedError`` naming the ROADMAP
item; with no device and no card it raises.  The reference's
``launch.train`` fails on the installed JAX (R4), so nothing here runs
it.
"""
import json
import os

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import train

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


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-tiny"])
def test_family_relaunch_from_a_compressed_checkpoint(arch, tmp_path,
                                                      capsys):
    """The MoE + MLA and encoder-decoder smoke models (whisper fed zero
    frames): 4 steps with a compressed checkpoint every 2, then a relaunch
    to 6 that resumes from step 4 with finite losses.  deepseek-v3's
    expert stacks ``[L, E, d, f]`` and their m and v are in the
    checkpoint, m and v compressed."""
    argv = ["--arch", arch, "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--ckpt-compress"]
    _, _, first, _ = run(capsys, "--steps", "4", *argv)
    with open(tmp_path / "step_000000000004" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    if arch == "deepseek-v3-671b":
        for part in ("params", "m", "v"):
            entry = leaves[f"['{part}']['group1']['ffn']['wi']"]
            assert len(entry["shape"]) == 4 and entry["shape"][1] == 8
            assert ("codec" in entry) == (part != "params"), entry
    _, st, losses, out = run(capsys, "--steps", "6", *argv)
    assert out.splitlines()[0] == "resumed from step 4"
    assert out.splitlines()[1].startswith("step     4 loss ")
    assert len(first) == 4 and len(losses) == 2
    assert all(l == l and l < 20 for l in first + losses)
    assert int(st.step) == 6


@pytest.mark.parametrize("argv,match", [
    (["--data", "2"], "ROADMAP queue 1, item 6"),
    (["--model-par", "2"], "ROADMAP queue 1, item 6"),
    (["--arch", "hymba-15b"], r"item 6 \(M10c training"),
    (["--arch", "rwkv6-3b"], r"item 6 \(M10c training"),
    (["--arch", "rwkv6_3b"], r"item 6 \(M10c training"),  # module name
])
def test_refusals(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(BASE + ["--steps", "1"] + argv)


@pytest.mark.parametrize("arch", ["hymba-15b", "rwkv6-3b"])
def test_untrained_families_name_their_item(arch):
    """The hybrid's and RWKV's refusals name the queue item that trains
    them (6b-ii), and the other families are not refused."""
    with pytest.raises(NotImplementedError, match=r"6b-ii: the hybrid SSM "
                       r"and RWKV backward"):
        train.main(BASE + ["--steps", "1", "--arch", arch])
    for other in ("deepseek-v3-671b", "llama4-scout-17b-a16e",
                  "whisper-tiny", "granite-8b"):
        assert train.untrained(get_arch(other)) == ""


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
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
