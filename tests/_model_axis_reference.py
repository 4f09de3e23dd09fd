"""The reference's own functions on meshes with a ``model`` axis, run in a
process of their own (four forced host devices).

    python tests/_model_axis_reference.py IN.pkl OUT.pkl

``IN.pkl`` holds a list of jobs, each a dict with ``kind``, ``arch`` (a
smoke configuration), ``mesh`` (``(data, model)``) and its inputs as
numpy arrays; ``OUT.pkl`` gets one result a job, numpy trees.  Meshes are
built with Auto axes (``jax.make_mesh`` alone gives Explicit axes, which
the reference's sharding constraints reject on this JAX: ROADMAP R4) over
the first ``data * model`` devices.

* ``serve``: ``make_serve_fns`` — the prefill's last-token logits of
  ``tokens`` (and a VLM's ``patch_embeds``) into a cache of ``max_len``,
  then one ``decode_step`` of ``next`` at ``pos``: ``{"prefill",
  "decode"}`` f32 ``[B, V]``.
* ``moe``: ``transformer.moe_apply`` of one MoE layer's ``ffn`` params
  ``p`` on ``x`` under the mesh's policy, and its VJP against ``cot``:
  ``{"y", "dx", "dp"}``.
* ``train``: ``make_train_step`` from ``params`` over ``batches``, each
  step's start state (``params``, ``m``, ``v``, ``step``), its gradients
  (``jax.grad`` of ``Model.loss`` under the step's policy and
  shardings, the tree ``AdamW.update`` is handed), loss, gradient norm,
  and the parameters after it: ``{"steps": [...]}``.
* ``gap``: the reference's own gradients of ``Model.loss`` from its
  weights drawn from ``PRNGKey(0)`` (its stacked draw) on one device and
  under the mesh's policy, on ``tokens`` (labels the tokens; the audio
  family's frames zeros): each leaf's norm on both, by its path:
  ``{"one": {...}, "mesh": {...}}`` (ROADMAP R15).
"""
import os
import pickle
import sys

# four host devices, each computing on one thread, to load the CPU less
# beside the test suite's other workers
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4"
                           + " --xla_cpu_multi_thread_eigen=false"
                           + " intra_op_parallelism_threads=1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.distributed import sharding as shlib  # noqa: E402
from repro.distributed.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro.distributed.train import (  # noqa: E402
    make_serve_fns,
    make_train_step,
)
from repro.models import build_model  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402


def host(tree):
    """numpy copies (a step donates its buffers)."""
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def f32(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)), tree)


def mesh_of(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def bf16(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def serve(job):
    cfg = get_smoke(job["arch"])
    model = build_model(cfg)
    mesh = mesh_of(job["mesh"])
    prefill_fn, decode_fn, _, param_sh = make_serve_fns(model, mesh)
    batch = {"tokens": jnp.asarray(job["tokens"])}
    if "patch_embeds" in job:
        batch["patch_embeds"] = jnp.asarray(job["patch_embeds"],
                                            jnp.bfloat16)
    with mesh:
        params = jax.device_put(bf16(job["params"]), param_sh)
        logits, cache = prefill_fn(params, batch, job["max_len"])
        first = f32(logits)
        logits, _ = decode_fn(params, cache, jnp.asarray(job["next"]),
                              jnp.int32(job["pos"]))
    return {"prefill": first, "decode": f32(logits)}


def moe(job):
    cfg = get_smoke(job["arch"])
    mesh = mesh_of(job["mesh"])
    policy = shlib.ShardingPolicy(mesh)
    p = bf16(job["p"])
    x = jnp.asarray(job["x"], jnp.bfloat16)
    cot = jnp.asarray(job["cot"], jnp.bfloat16)

    def fn(p, x):
        with shlib.activate(policy):
            return tfm.moe_apply(cfg, p, x)

    with mesh:
        y, vjp = jax.vjp(jax.jit(fn), p, x)
        dp, dx = vjp(cot)
    return {"y": f32(y), "dx": f32(dx), "dp": f32(dp)}


def train(job):
    cfg = get_smoke(job["arch"])
    model = build_model(cfg)
    mesh = mesh_of(job["mesh"])
    opt = AdamW(AdamWConfig(**job["opt"]))
    ts = make_train_step(model, opt, mesh)

    def grad(p, b):
        with shlib.activate(ts.policy):
            return jax.grad(model.loss)(p, b)

    grad_fn = jax.jit(grad, in_shardings=(ts.param_shardings, None),
                      out_shardings=ts.param_shardings)
    steps = []
    with mesh:
        p = jax.device_put(bf16(job["params"]), ts.param_shardings)
        st = opt.init(p)
        for tokens, labels in job["batches"]:
            start = {"params": host(p), "m": host(st.m), "v": host(st.v),
                     "step": int(np.asarray(st.step))}
            b = {"tokens": jnp.asarray(tokens),
                 "labels": jnp.asarray(labels)}
            grads = f32(grad_fn(p, b))  # before the step donates p
            p, st, met = ts.step_fn(p, st, b)
            steps.append({"start": start, "grads": grads,
                          "loss": float(met["loss"]),
                          "grad_norm": float(met["grad_norm"]),
                          "params": host(p)})
    return {"steps": steps}


def gap(job):
    from repro.models.common import init_params

    cfg = get_smoke(job["arch"])
    model = build_model(cfg)
    params = init_params(model.param_specs(), jax.random.PRNGKey(0))
    tokens = jnp.asarray(job["tokens"])
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "audio":
        batch["frames"] = jnp.zeros(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model), jnp.bfloat16)
    policy = shlib.ShardingPolicy(mesh_of(job["mesh"]))

    def sharded(p, b):
        with shlib.activate(policy):
            return jax.grad(model.loss)(p, b)

    one = jax.jit(jax.grad(model.loss))(params, batch)
    with policy.mesh:
        two = jax.jit(sharded)(params, batch)

    def norms(tree):
        return {jax.tree_util.keystr(path): float(np.linalg.norm(
            np.asarray(g, np.float32)))
            for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]}

    return {"one": norms(one), "mesh": norms(two)}


def main(inp: str, out: str) -> None:
    with open(inp, "rb") as f:
        jobs = pickle.load(f)
    kinds = {"serve": serve, "moe": moe, "train": train, "gap": gap}
    res = [kinds[job["kind"]](job) for job in jobs]
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
