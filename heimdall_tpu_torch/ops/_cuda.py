"""Build and load the port's CUDA kernels.

Each source in ``heimdall_tpu_torch/csrc`` is compiled by ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers: seconds, not
minutes) under ``heimdall_tpu_torch/_build/``, named by a hash of the
source, the shared ``*.cuh`` headers and the flags, at first use.
``build`` starts one ``nvcc`` per missing library, all at once.  Libraries
are loaded with ``ctypes``; pointers and the stream are passed as
``c_void_p``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signatures, by source name.
SIGNATURES = {
    "fused_detect": {
        "hd_fused_detect": [_P, _I, _I, _I, _I, _LL, _LL, _I, _I, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P],
        "hd_label_tiles": [_I, _I],
        "hd_fused_detect_launches": [_I, _I],
        "hd_preprocess": [_P, _I, _I, _I, _I, _LL, _LL, _I, _P, _P, _P, _P,
                          _P],
        "hd_label": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
        "hd_label_launches": [_I, _I, _I],
    },
    "stats_labels": {
        "hd_stats_from_labels": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _P],
        "hd_stats_scratch": [_I, _I, _I],
        "hd_stats_from_labels_launches": [],
    },
    "ccl_tiled": {
        "hd_flood_fill": [_P, _I, _I, _I, _P, _P, _P, _P],
        "hd_flood_entries": [_I, _I],
        "hd_band_ccl": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "hd_merge_bands": [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P],
        "hd_flood_fill_sp": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                             _P],
        "hd_flood_fill_sp_cluster": [_I, _I],
        "hd_band_ccl_sp": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P],
    },
    "runtable_tiled": {
        "hd_run_extract": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        "hd_flood_fix": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
        "hd_fill_extract": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P],
        "hd_label_fix": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P],
        "hd_writeback": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    },
    "pre_variants": {
        "hd_pre_variant": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P],
        "hd_mxu_mean": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    },
    "fill_sweeps": {
        "hd_run_ids": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
        "hd_sweep_fill": [_P, _I, _I, _I, _I, _I, _P, _P],
    },
    "ccl_sweeps": {
        "hd_sweep_ccl": [_P] + [_I] * 12 + [_P] * 7,
        "hd_sweep_ccl_clusters": [_I] * 4,
        "hd_runtable_ccl": [_P] + [_I] * 6 + [_P] * 8,
    },
    "joint_label": {
        "hd_joint_label": [_P] + [_I] * 7 + [_P] * 7,
        "hd_joint_label_clusters": [_I] * 4,
    },
    "primitives": {
        "hd_primitive_steps": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    },
    "stats_tiled": {
        "hd_banded_stats": [_P, _I, _LL, _LL, _LL, _I, _I, _I, _I, _P, _P,
                            _P, _P, _P, _P, _P, _P],
        "hd_bbox_sums": [_P, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P, _P],
        "hd_banded_stats_sp": [_P, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I, _P,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
}


def nvcc_path() -> str:
    """The nvcc of $CUDA_HOME, of PATH, or of /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu is built, keyed by its content,
    the shared headers' and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile every missing library in parallel; returns {name: path}."""
    BUILD_DIR.mkdir(exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built first if needed)."""
    lib = ctypes.CDLL(str(build((name,))[name]))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
