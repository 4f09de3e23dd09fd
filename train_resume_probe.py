#!/usr/bin/env python3
"""How a resume from a compressed train-state checkpoint moves the next
steps' losses, by the rule that brings the restored Adam state back.

    python3 train_resume_probe.py [--layers 2] [--seed 0] [--device cpu]
        [--smoke] [--seq 4096] [--out PATH]

granite-8b at full width (``--layers`` of its 36; ``--smoke``: the smoke
configuration), batch 2 x ``--seq`` from ``TokenPipeline``, AdamW at
``chip_smoke.TRAIN_OPT``.  Run A takes 6 steps from the seed's weights,
and again (the card's determinism).  Run B takes steps 0-1, saves its
state with ``save_train_state(compress=True)``, restores it, and resumes
at step 2 under each rule for the restored m and v:

  exact       m and v as they were before the save (a raw checkpoint);
  project     ``AdamW.project``: v at least ``(m / C)**2`` (the port's);
  abs         v's absolute value;
  consistent  v at least ``m**2 (1 - b2) / (1 - b1)**2``, the ratio of a
              gradient that keeps its value;
  zero_m      m zeroed and v floored at 0 where v came back negative.

Prints one JSON object: each run's losses (steps 2-5 for the resumes), and
the restored v's negative count.  The compressed checkpoint is encoded and
decoded on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RULES = ("exact", "project", "abs", "consistent", "zero_m")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card when omitted, 'cpu' for the host")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from chip_smoke import TRAIN_OPT
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.convert import (
        _copy,
        _unstacked,
        save_train_state,
        train_state_tree,
    )
    from repro_torch.serving.engine import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = resolve_device(args.device)
    cfg = (get_smoke if args.smoke else get_arch)("granite-8b")
    cfg = cfg.replace(num_layers=args.layers)
    gen = torch.Generator(device=dev)
    model = build_model(cfg, device=dev, generator=gen.manual_seed(args.seed))
    opt = AdamW(AdamWConfig(**TRAIN_OPT))
    ts = make_train_step(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, 2, args.seq, seed=args.seed)
    batches = [make_batch(cfg, pipe, i) for i in range(6)]

    def restart():
        with torch.no_grad():
            model.init_weights(gen.manual_seed(args.seed))
        return ts.init()

    def run(st, first, last):
        losses = []
        for i in range(first, last):
            st, met = ts.step_fn(st, batches[i])
            losses.append(float(met["loss"]))
        return st, losses

    out = {"config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                      "seq": args.seq, "device": str(dev)}}
    out["A"] = run(restart(), 0, 6)[1]
    out["A_again"] = run(restart(), 0, 6)[1]
    st, _ = run(restart(), 0, 2)
    saved = {n: (p.detach().clone(), st.m[n].clone(), st.v[n].clone())
             for n, p in model.named_parameters()}
    tmp = tempfile.mkdtemp(prefix="fptc_resume_")
    try:
        save_train_state(tmp, 2, model, st, compress=True, device=dev)
        step, got = ckpt.restore_latest(tmp, train_state_tree(model, st),
                                        device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    m_back, v_back = _unstacked(got["m"], model), _unstacked(got["v"], model)
    out["restored_v_negative"] = sum(int((torch.as_tensor(v) < 0).sum())
                                     for v in v_back.values())
    out["elements"] = sum(p.numel() for p in model.parameters())
    c = opt.config
    for rule in RULES:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n][0])
                m, v = st.m[n], st.v[n]
                if rule == "exact":
                    m.copy_(saved[n][1])
                    v.copy_(saved[n][2])
                    continue
                _copy(m, m_back[n], n)
                _copy(v, v_back[n], n)
                if rule == "abs":
                    v.abs_()
                elif rule == "consistent":
                    v.copy_(torch.maximum(
                        v, m * m * (1 - c.b2) / (1 - c.b1) ** 2))
                elif rule == "zero_m":
                    m.masked_fill_(v < 0, 0.0)
                    v.clamp_(min=0.0)
        if rule == "project":
            opt.project(st)
        st = st._replace(step=torch.tensor(step, dtype=torch.int32,
                                           device=dev))
        st, out[rule] = run(st, 2, 6)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
