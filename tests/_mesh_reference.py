"""The reference's own sharded train steps, run in a process of their own.

    python tests/_mesh_reference.py IN.pkl OUT.pkl

``IN.pkl`` holds ``{"params": the smoke granite's parameters (numpy),
"batches": [(tokens, labels), ...] global batches, "opt": AdamWConfig
fields, "min_size": the compressor's}``.  Two meshes are built with Auto
axes on forced host devices (``jax.make_mesh`` alone gives Explicit
axes, which the reference's sharding constraints reject on this JAX):
``(pod 2, data 1, model 1)`` for the pod-compressed step (each batch split
into a leading replica axis) and ``(data 2, model 1)`` for the FSDP step.
``OUT.pkl`` gets each mode's per-step losses and gradient norms, its
final parameters, optimizer state and (compressed) residual, as numpy
trees; the pod-compressed mode also each step's start (``steps``: the
parameters, the optimizer state, and each replica's loss and gradients
there, as its ``step_inner`` takes them), so that its steps can be taken
one at a time from the reference's own states.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.distributed.compression import CompressionConfig  # noqa: E402
from repro.distributed.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro.distributed.train import make_train_step  # noqa: E402
from repro.models import build_model  # noqa: E402


def host(tree):
    """numpy copies (the step donates its buffers)."""
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


def run(model, params, batches, opt, shape, names, compression, replicas):
    mesh = jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))
    ts = make_train_step(model, opt, mesh, compression=compression)
    assert ts.replicas == replicas
    per_replica = jax.jit(jax.vmap(
        lambda p, b: jax.value_and_grad(model.loss)(p, b),
        in_axes=(None, 0)))
    with mesh:
        p = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params),
                           ts.param_shardings)
        st = opt.init(p, with_residual=ts.compressor is not None,
                      replicas=replicas)
        losses, norms, steps = [], [], []
        for tokens, labels in batches:
            b = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
            if replicas > 1:
                b = jax.tree_util.tree_map(
                    lambda x: x.reshape((replicas, -1) + x.shape[1:]), b)
                hp = host(p)
                rl, rg = per_replica(
                    jax.tree_util.tree_map(jnp.asarray, hp),
                    jax.tree_util.tree_map(np.asarray, b))
                steps.append({"params": hp, "state": host(st._asdict()),
                              "losses": np.asarray(rl), "grads": host(rg)})
            p, st, met = ts.step_fn(p, st, b)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    return {"losses": losses, "norms": norms, "params": host(p),
            "state": host(st._asdict()),
            "residual": None if st.residual is None else host(st.residual),
            "steps": steps}


def main(inp: str, out: str) -> None:
    with open(inp, "rb") as f:
        d = pickle.load(f)
    model = build_model(get_smoke("granite_8b"))
    opt = AdamW(AdamWConfig(**d["opt"]))
    res = {
        "pod": run(model, d["params"], d["batches"], opt, (2, 1, 1),
                   ("pod", "data", "model"),
                   CompressionConfig(min_size=d["min_size"]), 2),
        "data": run(model, d["params"], d["batches"], opt, (2, 1),
                    ("data", "model"), None, 1),
    }
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
