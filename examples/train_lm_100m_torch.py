"""Train a ~100M-parameter LM on the PyTorch port: the twin of
``examples/train_lm_100m.py``.

AdamW, the deterministic token pipeline, FPTC-compressed checkpoints of
the train state (m and v encoded on the card's K4 and decoded on K1 + K2
when it resumes) and straggler timing, on one device.

  PYTHONPATH=src python examples/train_lm_100m_torch.py --steps 300 \
      [--device cpu] [--dir DIR] [--smoke]
  (kill it mid-run and relaunch: it resumes from the last checkpoint)

``--smoke`` trains a 2-layer, 128-wide model of the same shape family (a
CPU check of the loop); ``--dir`` defaults to a directory under the
system's temporary directory.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.elastic import StepTimer
from repro_torch.distributed.optimizer import AdamW, AdamWConfig
from repro_torch.distributed.train import make_train_step
from repro_torch.models import ArchConfig, build_model
from repro_torch.models.convert import (
    load_train_state,
    save_train_state,
    train_state_tree,
)
from repro_torch.serving.engine import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="the card when omitted, 'cpu' for the host")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "fptc_lm_100m_torch"))
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer, 128-wide model (CPU check)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # ~100M params: 12L x d768 x ff3072, 32k vocab (GPT-2-small class)
    cfg = ArchConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32768,
        head_dim=64,
    )
    if args.smoke:
        cfg = cfg.replace(name="lm-100m-smoke", num_layers=2, d_model=128,
                          num_heads=2, num_kv_heads=2, d_ff=512,
                          vocab_size=4096)
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    opt = AdamW(AdamWConfig(base_lr=6e-4, warmup=20, total_steps=args.steps))
    ts = make_train_step(model, opt, dev)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed)

    state = ts.init()
    start = 0
    restored = ckpt.restore_latest(args.dir, train_state_tree(model, state),
                                   device=dev)
    if restored:
        start, tree = restored
        state = load_train_state(tree, model, state, start, opt)
        del tree
        print(f"resumed from step {start}")

    timer = StepTimer()
    losses = []
    for step in range(start, args.steps):
        tokens, labels = pipe.batch(step)
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}
        timer.start()
        state, metrics = ts.step_fn(state, batch)
        loss = float(metrics["loss"])
        dt, straggler = timer.stop()
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt:6.2f}s" + ("  [straggler]" if straggler else ""),
                  flush=True)
        if (step + 1) % args.ckpt_every == 0:
            raw = sum(t.numel() * t.element_size() for t in (
                *model.parameters(), *state.m.values(), *state.v.values()))
            t0 = time.time()
            path = save_train_state(args.dir, step + 1, model, state,
                                    compress=True, device=dev)
            disk = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            print(f"  ckpt@{step+1}: {raw/1e6:.0f} MB state -> "
                  f"{disk/1e6:.0f} MB on disk "
                  f"(FPTC CR {raw/disk:.2f}x, {time.time()-t0:.1f}s)",
                  flush=True)
    print("done.")
    return losses


if __name__ == "__main__":
    main()
