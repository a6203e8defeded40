"""Correctness check of the run-table CCL against the sweep CCL on masks
made for it (counterpart of scripts/check_runtable.py; no timing).

For each of scene.check_runtable_masks (96x128) at R = 12 and 8 runs per
row: ccl_mask(mask, "cur") and ccl_runtable(mask, R) on the device must
both equal ops/ccl.py's connected_components, and the overflow mask (a row
of 20 runs) must report that it did not fit the tables.  Prints one line
per (mask, R) and exits non-zero on a failure.

Usage: python -m heimdall_tpu_torch.scripts.check_runtable [cpu]
"""

import sys

import numpy as np
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops.ccl import connected_components
from heimdall_tpu_torch.ops.ccl_sweeps import ccl_mask, ccl_runtable

RMAX = (12, 8)


def run_pair(mask: np.ndarray, rmax: int, device):
    """(sweep labels, run-table labels, fits) of one mask on device."""
    m = torch.from_numpy(np.ascontiguousarray(mask[None])).to(device)
    a = ccl_mask(m, "cur")
    b, fits = ccl_runtable(m, rmax)
    return a[0].cpu(), b[0].cpu(), bool(fits[0])


def main(argv=None) -> int:
    """Runs the check on the card (or with "cpu", the plain versions);
    returns the number of failures."""
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["cpu"]):
        raise SystemExit(__doc__.split("Usage: ")[1])
    if not argv and not torch.cuda.is_available():
        raise SystemExit("check_runtable runs on the card: no CUDA device "
                         "(pass cpu for the plain versions)")
    device = torch.device("cpu" if argv else "cuda")
    failures = 0
    for name, mask in scene.check_runtable_masks().items():
        want = connected_components(torch.from_numpy(mask > 0), 8)
        for rmax in RMAX:
            a, b, fits = run_pair(mask, rmax, device)
            ok = (torch.equal(a, want) and torch.equal(b, want)
                  and fits == (name != "overflow->fallback"))
            failures += not ok
            print(f"{'OK  ' if ok else 'FAIL'} {name} (Rmax={rmax}, "
                  f"tables {'taken' if fits else 'fell back'})"
                  + ("" if ok else f"  diff={int((a != b).sum())}"),
                  flush=True)
    print("ALL OK" if not failures else f"{failures} FAILURES", flush=True)
    return failures


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
