"""heimdall_tpu_torch imports neither jax (nor flax or optax) nor anything
of heimdall_tpu."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import heimdall_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    heimdall_tpu_torch.__path__, "heimdall_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "heimdall_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_nothing_of_heimdall_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20       # every module of the package was imported
    assert bad == "[]"


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "jax" not in src and "heimdall_tpu." not in src
    assert "flax" not in src and "optax" not in src
