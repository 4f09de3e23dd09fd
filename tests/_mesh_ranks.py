"""The rank side of ``tests/test_torch_mesh.py`` (no JAX here).

``run_ranks(world, jobs)`` spawns ``world`` processes
(``torch.multiprocessing``, spawn) in a gloo group on 127.0.0.1, its port
taken from a free socket; each runs the named jobs of this module in order
and sends back what they return, numpy only.  A rank that raises fails the
call with its traceback.
"""
import datetime
import pickle
import queue
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPT = dict(base_lr=1e-3, warmup=1, total_steps=20)  # TRAJ_OPT's
RANK_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, jobs) -> list:
    """``[[job results of rank r] for r in range(world)]``."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, jobs, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in procs:
            rank, err, blob = q.get(timeout=RANK_TIMEOUT_S)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            else:
                got[rank] = pickle.loads(blob)
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(got))} sent "
                      f"nothing in {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]


def _rank_main(rank, world, port, jobs, q):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            out = [globals()[name](**kw) for name, kw in jobs]
        finally:
            dist.destroy_process_group()
        q.put((rank, None, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises
        q.put((rank, traceback.format_exc(), None))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tensors(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v)).to(dtype)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------
def compressor(grads, residual, modes, min_size):
    """This rank's ``all_reduce`` (f32 residual) and ``replica_sum_ranks``
    (bf16 residual ``[1, ...]``) of ``grads[rank]`` in each mode, and what
    ``replicated_f32`` raises in ``all_reduce``."""
    from repro_torch.distributed.compression import (
        CompressionConfig,
        GradCompressor,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    g = _tensors(grads[rank])
    r32 = _tensors(residual[rank])
    r16 = {k: v[None].to(torch.bfloat16) for k, v in r32.items()}
    out = {}
    for mode in modes:
        comp = GradCompressor(CompressionConfig(mode=mode,
                                                min_size=min_size))
        if mode != "replicated_f32":
            mean, res = comp.all_reduce(g, world, r32)
            out["all_reduce", mode] = ({k: _np(v) for k, v in mean.items()},
                                       {k: _np(v) for k, v in res.items()})
        mean, res = comp.replica_sum_ranks(g, r16)
        out["ranks", mode] = ({k: _np(v) for k, v in mean.items()},
                              {k: _np(v) for k, v in res.items()})
    comp = GradCompressor(CompressionConfig(mode="replicated_f32",
                                            min_size=min_size))
    try:
        comp.all_reduce(g, world)
        out["replicated_f32_raises"] = None
    except ValueError as e:
        out["replicated_f32_raises"] = str(e)
    return out


def _model(params):
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax

    model = build_model(get_smoke("granite_8b"), device="cpu")
    params_from_jax(params, model)
    return model


def _step(params, mode, min_size=256):
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.launch.mesh import make_local_mesh

    world = dist.get_world_size()
    model = _model(params)
    if mode == "pod":
        mesh = make_local_mesh(pod=world, device_type="cpu")
        comp = CompressionConfig(min_size=min_size)
    else:
        mesh = make_local_mesh(data=world, device_type="cpu")
        comp = None
    return make_train_step(model, AdamW(AdamWConfig(**OPT)), mesh,
                           compression=comp), mesh


def _global(tokens, labels):
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


def train(params, batches, mode, ckpt_dir=None):
    """3 steps of the smoke granite from ``params`` on a ``pod`` or
    ``data`` mesh of every rank; ``ckpt_dir``: a raw checkpoint after
    step 1 (rank 0 writes it).  Returns the losses, the gradients' norms,
    the state whole at the start of each step (``starts``: the weights,
    m, v and the step count), the final weights whole, this rank's
    residual, and the elements this rank holds of the weights, m and
    v."""
    from repro_torch.models.convert import save_train_state

    ts, _ = _step(params, mode)
    st = ts.init()
    losses, norms, starts = [], [], []
    for i, (tokens, labels) in enumerate(batches):
        whole_p, whole = ts.full_state(st)
        starts.append({"params": {k: _np(v) for k, v in whole_p.items()},
                       "m": {k: _np(v) for k, v in whole.m.items()},
                       "v": {k: _np(v) for k, v in whole.v.items()},
                       "step": int(whole.step)})
        st, met = ts.step_fn(st, ts.local_batch(_global(tokens, labels)))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if ckpt_dir and i == 0:
            whole_p, whole = ts.full_state(st)
            if dist.get_rank() == 0:
                save_train_state(ckpt_dir, 1, ts.model, whole, device="cpu",
                                 params=whole_p)
            dist.barrier()
    whole_p, _ = ts.full_state(st)
    held = {"params": sum(p.numel() for p in ts.model.parameters()),
            "m": sum(t.numel() for t in st.m.values()),
            "v": sum(t.numel() for t in st.v.values())}
    return {"losses": losses, "norms": norms, "starts": starts,
            "params": {k: _np(v) for k, v in whole_p.items()},
            "residual": None if st.residual is None else
            {k: _np(v) for k, v in st.residual.items()},
            "held": held, "replicas": ts.replicas,
            "compressed": ts.compressor is not None}


def resume(params, batches, ckpt_dir):
    """Restore the newest checkpoint in ``ckpt_dir`` onto a ``data`` mesh
    of every rank (``remesh``), take the next step, and check that each
    remeshed leaf's DTensor is the host leaf.  Returns the step's loss."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed.elastic import remesh
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.models.convert import load_train_state

    ts, mesh = _step(params, "data")
    specs = ts.model.param_specs()
    like = {"params": specs, "m": specs, "v": specs}
    step, host = ckpt.restore_latest(ckpt_dir, like, device="cpu")
    placed = remesh(host, like, ts.policy or ShardingPolicy(mesh))
    whole_equal = all(
        torch.equal(d.full_tensor(), torch.as_tensor(h))
        for d, h in zip(_leaves(placed["m"]), _leaves(host["m"])))
    local = _map(lambda d: d.to_local(), placed)
    st = load_train_state(local, ts.model, ts.init(), step, ts.optimizer)
    tokens, labels = batches[step]
    st, met = ts.step_fn(st, ts.local_batch(_global(tokens, labels)))
    return {"step": step, "loss": float(met["loss"]),
            "whole_equal": whole_equal}


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def pod_steps(device, seed, steps, batch, seq, min_size):
    """``steps`` pod-compressed steps (``truncate_int8``) of the smoke
    granite drawn from ``seed`` on ``device``, one pod replica a rank, on
    ``smoke_batches``.  Returns the losses, the final weights and this
    rank's residual."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke("granite_8b")
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    mesh = make_local_mesh(pod=dist.get_world_size(), device_type=dev.type)
    ts = make_train_step(model, AdamW(AdamWConfig(**OPT)), mesh,
                         compression=CompressionConfig(min_size=min_size))
    st, losses = ts.init(), []
    for b in smoke_batches(cfg, seed, steps, batch, seq):
        st, met = ts.step_fn(st, ts.local_batch(b))
        losses.append(float(met["loss"]))
    return {"losses": losses,
            "params": {n: _np(p) for n, p in model.named_parameters()},
            "residual": {n: _np(r) for n, r in st.residual.items()}}


def smoke_batches(cfg, seed, steps, batch, seq):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        t = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        out.append(_global(t, t))
    return out


# ---------------------------------------------------------------------------
# The model axis (tests/test_torch_model_axis.py,
# tests/test_torch_moe_distributed.py)
# ---------------------------------------------------------------------------
def _axis_mesh(shape):
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(data=shape[0], model=shape[1], device_type="cpu")


def _rows(shape, b):
    """This rank's rows of a global batch of ``b`` on a (data, model)
    mesh."""
    k = b // shape[0]
    i = dist.get_rank() // shape[1]
    return slice(i * k, (i + 1) * k)


def serve(arch, params, tokens, max_len, next, pos, mesh,
          patch_embeds=None):
    """The smoke ``arch`` from the reference's ``params`` served on a
    (data, model) ``mesh``: this rank's rows' prefill logits and one
    decode step of ``next`` at ``pos``."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.train import make_serve_fns
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax

    model = build_model(get_smoke(arch), device="cpu")
    params_from_jax(params, model)
    prefill_fn, decode_fn = make_serve_fns(model, _axis_mesh(mesh))
    batch = {"tokens": torch.from_numpy(tokens)}
    if patch_embeds is not None:
        batch["patch_embeds"] = torch.from_numpy(patch_embeds).to(
            torch.bfloat16)
    logits, cache = prefill_fn(batch, max_len)
    rows = _rows(mesh, tokens.shape[0])
    dec, _ = decode_fn(cache, torch.from_numpy(next[rows]), pos)
    return {"prefill": _np(logits), "decode": _np(dec),
            "rows": (rows.start, rows.stop),
            "kv_heads": {k: tuple(v.shape) for k, v in
                         cache["group0"].items()}}


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _shape(specs, name):
    """A MoE spec's shape by its dotted name (``shared.wi``)."""
    for k in name.split("."):
        specs = specs[k]
    return specs.shape


def moe(arch, p, x, cot, mesh):
    """One MoE layer's ``moe_apply`` (the reference's ffn params ``p``,
    each rank its compute block) on this rank's rows of ``x`` under a
    (data, model) ``mesh``, and its backward against ``cot``.  Returns
    this rank's output block (its rows, its sequence block when the
    sequence divides the axis), its rows' input gradient summed over
    ``model``, and the weights' gradients: the router's summed over
    every rank, the others' this rank's block summed over the ranks
    that compute with it."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.train import mesh_policy
    from repro_torch.models import transformer as tfm
    from repro_torch.models.convert import to_torch

    cfg = get_smoke(arch)
    policy = mesh_policy(cfg, _axis_mesh(mesh))
    ax = policy.model_axis
    coord = policy.mesh.get_coordinate()
    specs = tfm.moe_specs(cfg)
    blocks = {}

    def local(t, s):
        sl = policy.local_slices(s.names, s.shape, coord, axis="model")
        return to_torch(t)[sl].clone().requires_grad_(True), sl

    pl = {}
    for k, s in specs.items():
        if isinstance(s, dict):
            pl[k] = {}
            for kk, ss in s.items():
                pl[k][kk], blocks[f"{k}.{kk}"] = local(p[k][kk], ss)
        else:
            pl[k], blocks[k] = local(p[k], s)
    rows = _rows(mesh, x.shape[0])
    xr = to_torch(x[rows]).to(torch.bfloat16).requires_grad_(True)
    stats = {}
    with shlib.activate(policy):
        ax.set_sequence(x.shape[1])
        y = tfm.moe_apply(cfg, pl, xr, stats)
        seq = slice(None)
        if ax.seq:
            start, n = ax.block(x.shape[1])
            seq = slice(start, start + n)
        c = to_torch(cot[rows, seq]).to(torch.bfloat16)
        if not ax.seq and ax.index:  # the output whole on every model
            c = torch.zeros_like(c)  # rank: its cotangent given once
        y.backward(c)
    dx = xr.grad.clone()
    dist.all_reduce(dx, group=ax.group)
    flat = {**{k: v for k, v in pl.items() if not isinstance(v, dict)},
            **{f"shared.{kk}": vv for kk, vv in pl.get("shared",
                                                         {}).items()}}
    grads = {k: t.grad.clone() for k, t in flat.items()}
    # the router whole on every rank: its gradient summed over all
    dist.all_reduce(grads["router"])
    # model-EP experts and the shared FFN: summed over the data ranks
    axes = tfm.expert_block(cfg, ax)[0]
    for k in grads:
        if k == "router" or ("data" in axes and k in ("wi", "wg", "wo")):
            continue
        if ax.dp_group is not None:
            dist.all_reduce(grads[k], group=ax.dp_group)
    return {"y": _np(y), "rows": (rows.start, rows.stop),
            "seq": (seq.start, seq.stop), "dx": _np(dx),
            "dp": {k: _np(g) for k, g in grads.items()},
            "blocks": {k: tuple(c.indices(n)[:2] for c, n in
                                zip(sl, _shape(specs, k)))
                       for k, sl in blocks.items()},
            "dropped": int(stats["dropped"]),
            "experts_hit": int(stats["experts_hit"])}


def axis_train(arch, starts, batches, mesh, opt):
    """One step at a time of the smoke ``arch`` on a (data, model)
    ``mesh``: each from the reference's own state at its start
    (``starts``: the parameters, m, v and step), placed by ``remesh``.
    Returns each step's loss, gradient norm, the gradients as the step
    hands them to ``AdamW.update`` and the weights after it, both
    gathered whole, and the elements this rank holds."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.elastic import remesh
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_train_state

    class Seen(AdamW):
        """AdamW that keeps the gradients it is handed."""

        def update(self, params, state, grads, *args, **kw):
            self.grads = grads
            return super().update(params, state, grads, *args, **kw)

    out = []
    optimizer = Seen(AdamWConfig(**opt))
    device_mesh = _axis_mesh(mesh)
    for start, (tokens, labels) in zip(starts, batches):
        model = build_model(get_smoke(arch), device="cpu")
        ts = make_train_step(model, optimizer, device_mesh)
        specs = model.param_specs()
        like = {"params": specs, "m": specs, "v": specs}
        placed = remesh({k: start[k] for k in like}, like, ts.policy)
        st = load_train_state(_map(lambda d: d.to_local(), placed), model,
                              ts.init(), start["step"], optimizer)
        st, met = ts.step_fn(st, ts.local_batch(_global(tokens, labels)))
        whole, _ = ts.full_state(st)
        out.append({"loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"]),
                    "grads": {k: _np(ts.layouts[k].gather(g))
                              for k, g in optimizer.grads.items()},
                    "params": {k: _np(v) for k, v in whole.items()},
                    "held": sum(p.numel() for p in model.parameters())})
    return out


def refusals(pod=None):
    """What ``make_train_step`` and ``make_serve_fns`` raise on a mesh:
    with ``pod``, a pod-compressed step on ``(pod, data 2)``; else the
    hybrid, RWKV and encoder-decoder families on ``(data 1, model 2)``.
    ``{case: message}``."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.distributed.optimizer import AdamW, AdamWConfig
    from repro_torch.distributed.train import (
        make_serve_fns,
        make_train_step,
    )
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model

    def message(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return None

    opt = AdamW(AdamWConfig(**OPT))
    if pod:
        mesh = make_local_mesh(data=2, pod=pod, device_type="cpu")
        model = build_model(get_smoke("granite_8b"), device="cpu")
        return {"pod_data": message(lambda: make_train_step(
            model, opt, mesh,
            compression=CompressionConfig(mode="truncate_int8")))}
    mesh, out = _axis_mesh((1, 2)), {}
    for arch in ("hymba_15b", "rwkv6_3b", "whisper_tiny"):
        model = build_model(get_smoke(arch), device="cpu")
        train = message(lambda: make_train_step(model, opt, mesh))
        serve = message(lambda: make_serve_fns(model, mesh))
        out[arch] = train if train == serve else (train, serve)
    return out


def compute_blocks(arch, mesh, seed):
    """``build_compute_blocks`` of the smoke ``arch`` on a (data, model)
    ``mesh`` against the whole model from the same seed cut to this
    rank's blocks (``to_compute_blocks``): ``{name: (equal, shape)}``."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.train import (
        build_compute_blocks,
        mesh_policy,
        to_compute_blocks,
    )
    from repro_torch.models import build_model

    cfg = get_smoke(arch)
    device_mesh = _axis_mesh(mesh)
    whole = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    to_compute_blocks(whole, mesh_policy(cfg, device_mesh))
    drawn = build_compute_blocks(cfg, device_mesh, "cpu",
                                 torch.Generator().manual_seed(seed))
    want = dict(whole.named_parameters())
    return {n: (torch.equal(p, want[n]), tuple(p.shape))
            for n, p in drawn.named_parameters()}
