"""FPTC-compressed checkpoints of a training state, on the PyTorch port: the
twin of ``examples/checkpoint_compression.py``.

Trains a ``configs/`` smoke model for a few steps so the optimizer state
has realistic (smooth-accumulator) statistics, then round-trips the whole
train state (``{"p", "m", "v"}`` in the reference's layout) through
:func:`repro_torch.distributed.checkpoint.save_checkpoint` with
``compress=True``: tables calibrated once over the whole tree
(``train_state`` domain), every large float leaf sharded into fixed-length
strips, and all shards encoded in one engine call (K4 on the card) into a
single ``state.fptc`` blob (manifest v2); the restore decodes it (K1 + K2).

Reports bytes saved against the raw checkpoint, the restore's
reconstruction error and the save and restore time per checkpoint into a
workloads report (``write_workloads_report``).

  PYTHONPATH=src python examples/checkpoint_compression_torch.py \
      [--smoke] [--device cpu] [--steps N] [--dir DIR] [--report PATH]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.optimizer import AdamW, AdamWConfig
from repro_torch.distributed.train import make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_tree
from repro_torch.serving.engine import resolve_device
from repro_torch.serving.workloads import write_workloads_report


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: fewer train steps and timing repeats")
    ap.add_argument("--model", default="qwen15_4b")
    ap.add_argument("--steps", type=int, default=None,
                    help="train steps before the checkpoint (default 6; "
                    "2 with --smoke)")
    ap.add_argument("--device", default=None,
                    help="the card when omitted, 'cpu' for the plain "
                    "PyTorch versions")
    ap.add_argument("--dir", default=os.path.join(
        tempfile.gettempdir(), "fptc_ckpt_example_torch"))
    ap.add_argument("--report", default=None,
                    help="the report file (default: workloads.json under "
                    "--dir)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.model)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    ts = make_train_step(model, AdamW(AdamWConfig(
        base_lr=1e-3, warmup=1, total_steps=20)), dev)
    state = ts.init()
    steps = args.steps if args.steps is not None else (
        2 if args.smoke else 6)
    for s in range(steps):
        toks = torch.from_numpy(np.random.default_rng(s).integers(
            0, cfg.vocab_size, (2, 16)))
        state, _ = ts.step_fn(state, {"tokens": toks, "labels": toks})

    tree = train_state_tree(model, state)
    host = {"p": tree["params"], "m": tree["m"], "v": tree["v"]}
    raw_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(host))

    # -- raw vs compressed checkpoint --------------------------------------
    base = ckpt.save_checkpoint(os.path.join(args.dir, "raw"), steps, host)
    raw_disk = _dir_bytes(base)
    repeats = 1 if args.smoke else 3
    t0 = time.perf_counter()
    for _ in range(repeats):
        comp = ckpt.save_checkpoint(os.path.join(args.dir, "comp"), steps,
                                    host, compress=True, device=dev)
    save_ms = (time.perf_counter() - t0) / repeats * 1e3
    comp_disk = _dir_bytes(comp)
    state_blob = os.path.getsize(os.path.join(comp, "state.fptc"))

    # -- restore + reconstruction error ------------------------------------
    t0 = time.perf_counter()
    step, restored = ckpt.restore_latest(os.path.join(args.dir, "comp"),
                                         host, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    restore_ms = (time.perf_counter() - t0) * 1e3
    assert step == steps
    num = den = 0.0
    for a, b in zip(tree_leaves(host), tree_leaves(restored)):
        a, b = _f32(a), _f32(b)
        num += float(np.sum((a - b) ** 2))
        den += float(np.sum(a ** 2))
    rel = (num / max(den, 1e-30)) ** 0.5

    print(f"train state: {raw_bytes/1e6:.2f} MB raw "
          f"({raw_disk/1e6:.2f} MB on disk)")
    print(f"compressed checkpoint: {comp_disk/1e6:.2f} MB "
          f"(state.fptc {state_blob/1e6:.2f} MB, CR "
          f"{raw_disk/comp_disk:.2f}x), restore rel err {rel:.5f}")
    print(f"save {save_ms:.1f} ms / restore {restore_ms:.1f} ms "
          f"(per checkpoint step)")

    report = args.report or os.path.join(args.dir, "workloads.json")
    payload = {
        "model": args.model, "device": str(dev), "train_steps": steps,
        "raw_bytes": int(raw_bytes), "raw_disk_bytes": int(raw_disk),
        "compressed_disk_bytes": int(comp_disk),
        "state_blob_bytes": int(state_blob),
        "bytes_saved": int(raw_disk - comp_disk),
        "ratio": comp_disk / raw_disk, "restore_rel_error": rel,
        "save_ms": save_ms, "restore_ms": restore_ms,
    }
    path = write_workloads_report("checkpoint", payload, path=report)
    print(f"report -> {path}")
    return payload


if __name__ == "__main__":
    main()
