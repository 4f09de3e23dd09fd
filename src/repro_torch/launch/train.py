"""End-to-end training driver on one device.  Port of
``repro/launch/train.py``.

Builds the model from ``--arch`` (the reduced ``--smoke`` configuration for
the CPU), draws its weights layer by layer from ``--seed``, streams
deterministic ``TokenPipeline`` batches, checkpoints ``{"params", "m",
"v"}`` in the reference's layout every ``--ckpt-every`` steps (atomic,
restartable; ``--ckpt-compress``: m and v FPTC-compressed, encoded on the
card's K4 and decoded on K1 + K2 when it resumes, the weights raw), and
resumes from the newest checkpoint in ``--ckpt-dir``: kill it mid-run and
relaunch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir DIR [--device cpu]

The reference's flags, plus ``--device`` (default: the card; ``cpu`` runs
the same arithmetic on the host) and ``--seed`` (weights and data).
``--data`` or ``--model-par`` above 1 raise ``NotImplementedError``;
every family trains: the dense, VLM, MoE, MLA, hybrid SSM, RWKV and
encoder-decoder families (whisper's frames are zeros, as the reference
feeds them).  ``--compression`` is
accepted and, on one device, leaves the step uncompressed, as the
reference does without a pod axis.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.distributed.elastic import StepTimer
from repro_torch.distributed.optimizer import AdamW, AdamWConfig
from repro_torch.distributed.train import make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import (
    load_train_state,
    save_train_state,
    train_state_tree,
)
from repro_torch.serving.engine import resolve_device

__all__ = ["main", "make_batch"]

MULTI_DEVICE = ("ROADMAP queue 1, item 6 (M10d: the multi-device layer — "
                "data and model parallelism)")


def make_batch(cfg, pipe: TokenPipeline, step: int) -> dict:
    """Batch ``step`` of ``pipe`` as tensors; a VLM's patch prefix and the
    audio family's frames ``[B, encoder_seq, d]`` are zeros, as the
    reference feeds them."""
    tokens, labels = pipe.batch(step)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    if cfg.family == "vlm" and cfg.vision_prefix:
        batch["patch_embeds"] = torch.zeros(
            (pipe.batch_size, cfg.vision_prefix, cfg.d_model),
            dtype=torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(
            (pipe.batch_size, cfg.encoder_seq, cfg.d_model),
            dtype=torch.bfloat16)
    return batch


def main(argv=None):
    """Run the driver; returns ``(model, opt_state, losses)``, the losses
    of the steps this launch took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-compress", action="store_true",
                    help="FPTC-compress checkpoint leaves")
    ap.add_argument("--compression", default="none",
                    choices=["none", "truncate", "truncate_int8"])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.data != 1 or args.model_par != 1:
        raise NotImplementedError(
            f"--data {args.data} --model-par {args.model_par}: the port "
            f"trains on one device; see {MULTI_DEVICE}")

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    opt = AdamW(AdamWConfig(base_lr=args.lr, warmup=10,
                            total_steps=args.steps))
    ts = make_train_step(model, opt, dev, compression=CompressionConfig(
        mode=args.compression))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch_size=args.batch,
                         seq_len=args.seq, seed=args.seed)

    opt_state = ts.init()
    start_step = 0
    if args.ckpt_dir:
        restored = ckpt.restore_latest(
            args.ckpt_dir, train_state_tree(model, opt_state), device=dev)
        if restored is not None:
            start_step, tree = restored
            opt_state = load_train_state(tree, model, opt_state, start_step,
                                         opt)
            del tree
            print(f"resumed from step {start_step}")

    timer = StepTimer()
    losses = []
    for step in range(start_step, args.steps):
        batch = make_batch(cfg, pipe, step)
        timer.start()
        opt_state, metrics = ts.step_fn(opt_state, batch)
        loss = float(metrics["loss"])  # the log line's one host sync
        dt, straggler = timer.stop()
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"{dt*1e3:7.1f} ms" + ("  [straggler]" if straggler else ""),
                flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save_train_state(args.ckpt_dir, step + 1, model,
                                    opt_state, compress=args.ckpt_compress,
                                    device=dev)
            print(f"checkpointed -> {path}", flush=True)
    print("training done.")
    return model, opt_state, losses


if __name__ == "__main__":
    main()
