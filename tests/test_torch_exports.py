"""Each subpackage of heimdall_tpu_torch exports at package level every
public name that heimdall_tpu's does (``from heimdall_tpu_torch.ops import
canny`` works where ``from heimdall_tpu.ops import canny`` does), and
importing ``ops`` builds no CUDA library.

The comparison runs in a subprocess that imports both packages (jax on
the CPU).  Submodules bound as attributes by being imported are not
names of a package's interface and are left out."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, inspect, json, pkgutil
import heimdall_tpu, heimdall_tpu_torch

def public(pkg):
    return sorted(n for n, v in vars(pkg).items() if not n.startswith("_")
                  and not (inspect.ismodule(v)
                           and v.__name__ == f"{pkg.__name__}.{n}"))

subs = [""] + sorted(m.name for m in pkgutil.iter_modules(
    heimdall_tpu.__path__) if m.ispkg)
out = {}
for s in subs:
    suffix = "." + s if s else ""
    jax_names = public(importlib.import_module("heimdall_tpu" + suffix))
    try:
        port = importlib.import_module("heimdall_tpu_torch" + suffix)
    except ImportError as e:
        out[s] = {"missing_package": str(e)}
        continue
    out[s] = {"jax": jax_names, "port": public(port)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def names():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


SUBPACKAGES = ("", "camera", "core", "detectors", "inspection", "lighting",
               "models", "ops", "parallel", "perf", "runtime", "serving",
               "utils")


def test_every_subpackage_is_compared(names):
    assert set(names) == set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_jax_public_names(names, sub):
    entry = names[sub]
    assert "missing_package" not in entry, entry
    missing = sorted(set(entry["jax"]) - set(entry["port"]))
    assert not missing, f"heimdall_tpu_torch.{sub} lacks {missing}"


def test_ops_and_detectors_exports_import():
    code = ("from heimdall_tpu_torch.ops import canny, BlobTable, ccl, "
            "demosaic_bilinear\n"
            "from heimdall_tpu_torch.detectors import ContaminationDetector\n"
            "from heimdall_tpu_torch.parallel import make_mesh, multihost\n"
            "from heimdall_tpu_torch.ops import _cuda\n"
            "assert _cuda.library.cache_info().currsize == 0\n"
            "import heimdall_tpu_torch.ops.blobs, "
            "heimdall_tpu_torch.ops.stats_tiled\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
