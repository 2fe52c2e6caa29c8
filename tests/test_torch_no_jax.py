"""The port runs without JAX: every module of `autoposeestimation_tpu_torch`
imports in a fresh interpreter where `jax` and `autoposeestimation_tpu`
cannot be imported, and none of them is loaded afterwards."""
import os
import subprocess
import sys

PROBE = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "optax", "autoposeestimation_tpu"):
    sys.modules[blocked] = None          # any import of it raises
import autoposeestimation_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
    or k == "autoposeestimation_tpu"
    or k.startswith("autoposeestimation_tpu.")))
print(len(names), loaded)
"""


def test_port_imports_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.split(" ", 1)
    assert int(count) >= 30
    assert loaded.strip() == "[]"


def test_port_imports_without_pil_or_matplotlib():
    """As on the card's machine, which has neither Pillow nor matplotlib:
    every port module imports with them blocked too, and none loads
    them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = PROBE.replace(
        '"autoposeestimation_tpu"):',
        '"autoposeestimation_tpu", "PIL", "matplotlib"):').replace(
        'or k == "autoposeestimation_tpu"',
        'or k in ("autoposeestimation_tpu", "PIL", "matplotlib")'
        ' or k.split(".")[0] in ("PIL", "matplotlib")')
    assert probe.count("PIL") == 3
    res = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.split(" ", 1)
    assert int(count) >= 37
    assert loaded.strip() == "[]"
