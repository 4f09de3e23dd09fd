"""The port imports no JAX: every module of ``repro_torch``, imported in a
fresh interpreter, leaves no ``jax``, ``jaxlib`` or ``repro`` module
loaded; ``chip_smoke.py`` names none of them in an import statement."""
import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "repro")

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in %r)}))
""" % (FORBIDDEN,)


def test_no_module_of_the_port_loads_jax_or_the_reference():
    import json

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("repro_torch.launch.train", "repro_torch.distributed."
                 "optimizer", "repro_torch.distributed.elastic",
                 "repro_torch.models.convert", "repro_torch.kernels.ops",
                 "repro_torch.models.ssm"):
        assert name in out["modules"]
    assert out["loaded"] == []


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & set(FORBIDDEN)
