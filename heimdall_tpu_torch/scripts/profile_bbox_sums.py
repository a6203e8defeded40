"""B4b, the bbox-window sums (csrc/stats_tiled.cu, hd_bbox_sums through
ops/stats_tiled.py::bbox_sums), timed on the card at the 2 MP main path's
batch on three inputs:

* bench_mono8: the bench frames' G plane through the band route (the
  detector's Mono8 route), gray only;
* bench_bgr: the bench frames as BGR planes through the run-table route
  (the detector's BGR route), gray and the three planes;
* window_cases: scene.window_case_masks(1080, 1920) repeated over the batch
  (one blob over the whole frame, a disk over 7 of 9 bands, ...), labeled
  by the band route, with random gray and BGR planes: large windows.
  --cases a,b,... repeats only the named cases (a name may come again),
  e.g. --cases whole for a batch whose every frame is one window.

Each beside its byte bound (window_bytes: C bytes a window pixel, C = 1 or
4, the listed slot ids, the band counts and each listed slot's bbox read,
4 sums a slot written, at 3.35 TB/s), one empty kernel's time
(torch.cuda._sleep(0): one launch's floor) and the kernel's time on the
same batch with every slot list empty.  Every run is queued behind a spin
kernel, so only the card's time counts.

    python -m heimdall_tpu_torch.scripts.profile_bbox_sums [batch] [iters]
        [--cases a,b,...]

Prints the card (nvidia-smi's name and power limit), a line per
measurement and one JSON line.  Exits with an error where there is no
card.
"""

import json
import sys

import numpy as np
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.detectors.contamination_detector import TILED_BAND
from heimdall_tpu_torch.ops import ccl_tiled as ct
from heimdall_tpu_torch.ops import fused_kernels as fk
from heimdall_tpu_torch.ops import preprocess_tiled as pt
from heimdall_tpu_torch.ops import runtable_tiled as rt
from heimdall_tpu_torch.ops import stats_tiled as st
from heimdall_tpu_torch.scripts.timing import card, queued_ms, require_card

BATCH = 128            # the 2 MP main path's batch
H, W = 1080, 1920
K = 64
CONTRAST = 15
RT_BG, RT_FG = 8, 7    # the detector's run-table widths
HBM_BYTES_PER_S = 3.35e12
USAGE = ("usage: python -m heimdall_tpu_torch.scripts.profile_bbox_sums "
         "[batch] [iters] [--cases a,b,...]")


def window_bytes(bbox, slot_list, slot_count, band: int, channels: int):
    """Bytes the bbox sums must move on these inputs: `channels` bytes (1,
    or 4 with colour) of each pixel of each listed (slot, band) pair's
    window within the band, each listed slot id, the band counts and the
    bbox (16 bytes) of each slot listed in some band read, and 4 int32 sums
    a slot written.  The bboxes of slots that no band lists are not read."""
    n, R = slot_count.shape
    Kb = bbox.shape[-1]
    listed = (torch.arange(Kb, device=bbox.device)
              < slot_count.clamp(max=Kb)[..., None].long())
    ids = torch.where(listed, slot_list.long(), 0)
    bb = bbox.long().gather(2, ids.reshape(n, 1, -1).expand(
        -1, 4, -1)).reshape(n, 4, R, Kb)
    top = torch.arange(R, device=bbox.device)[None, :, None] * band
    rows = (torch.minimum(bb[:, 3], top + band - 1)
            - torch.maximum(bb[:, 1], top) + 1).clamp(min=0)
    cols = (bb[:, 2] - bb[:, 0] + 1).clamp(min=0)
    pixels = int((rows * cols * listed).sum())
    seen = torch.zeros((n, Kb + 1), dtype=torch.bool, device=bbox.device)
    seen.scatter_(1, torch.where(listed, ids, Kb).reshape(n, -1), True)
    boxes = int(seen[:, :Kb].sum())
    return (pixels * channels + boxes * 16
            + (int(listed.sum()) + n * (R + 4 * Kb)) * 4)


def bench_frames(batch: int):
    """(Mono8 [batch, H, W], BGR planes [batch, 3, H, W]) of the 2 MP bench
    scene (seed 2, as chip_smoke.py's main path), uint8 on the card."""
    frames = scene.make_frames(batch, H, W, seed=2)
    mono = torch.from_numpy(np.ascontiguousarray(frames[..., 1])).cuda()
    bgr = torch.from_numpy(
        np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).cuda()
    return mono, bgr


def make_inputs(mono, bgr, band: int = TILED_BAND, k: int = K, cases=None):
    """{input: (bbox_sums arguments, channels)} for the three inputs, made
    by the detector's kernels from the bench frames `mono` and `bgr` (on the
    card) and from the window cases at the same size and batch (`cases`: the
    names of scene.window_case_masks repeated over the batch; all of them
    by default)."""
    out = {}
    gray, binary = fk.preprocess(mono, CONTRAST)
    filled = ct.fill_holes_tiled(binary, band=band)
    labels, rl, n, sl, sc = ct.connected_components_tiled(
        filled, band=band, return_roots=k, band_slots=True)
    bbox = st.banded_stats(labels, filled, gray, None, rl, n, k)[1]
    out["bench_mono8"] = ((bbox, sl, sc, band, gray), 1)

    binary, gray, *tables = pt.contamination_preprocess_tiled(
        bgr, CONTRAST, True, bg_tables=RT_BG)
    filled, labels, rl, n, sl, sc = rt.fill_label_runtable_tiled(
        binary, band, max_blobs=k, r_bg=RT_BG, r_fg=RT_FG,
        pre_extracted=tables)
    bbox = st.banded_stats(labels, filled, gray, bgr, rl, n, k, True)[1]
    out["bench_bgr"] = ((bbox, sl, sc, band, gray, bgr, True), 4)

    B, h, w = mono.shape
    dev = mono.device
    named = scene.window_case_masks(h, w)
    cases = torch.from_numpy(np.stack(
        [named[c] for c in (cases or named)])).to(dev)
    masks = cases[torch.arange(B, device=dev) % len(cases)]
    gen = torch.Generator(device=dev).manual_seed(0)
    gray = torch.randint(0, 256, (B, h, w), generator=gen, device=dev,
                         dtype=torch.uint8)
    color = torch.randint(0, 256, (B, 3, h, w), generator=gen, device=dev,
                          dtype=torch.uint8)
    labels, rl, n, sl, sc = ct.connected_components_tiled(
        masks, band=band, return_roots=k, band_slots=True)
    bbox = st.banded_stats(labels, masks, gray, color, rl, n, k, True)[1]
    out["window_cases"] = ((bbox, sl, sc, band, gray, color, True), 4)
    return out


def window_case_checks(h: int, w: int, bands, ks, dev, seed: int = 0):
    """The cases on which the banded stats and the bbox sums are held
    against their plain versions: scene.window_case_masks(h, w) on random
    gray and BGR bytes (a torch.Generator on `dev` seeded `seed`), labeled
    by the band route at each band of `bands` and K of `ks`, without colour,
    with BGR frames and with BGR planes.  Yields (band, name, banded_stats
    arguments, [bbox_sums arguments after the bbox, with the labeling's slot
    counts and with the counts raised past K])."""
    masks = torch.from_numpy(np.stack(list(
        scene.window_case_masks(h, w).values()))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gray = torch.randint(0, 256, masks.shape, generator=gen, device=dev,
                         dtype=torch.uint8)
    frames = torch.randint(0, 256, (*masks.shape, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    colors = {"gray": (None, False), "bgr": (frames, False),
              "bgr_planes": (frames.permute(0, 3, 1, 2).contiguous(), True)}
    for band in bands:
        for k in ks:
            labels, rl, n, sl, sc = ct.connected_components_tiled(
                masks, band=band, return_roots=k, band_slots=True)
            for form, (color, cm) in colors.items():
                yield (band, f"k{k}_{form}",
                       (labels, masks, gray, color, rl, n, k, cm),
                       [(sl, counts, band, gray, color, cm)
                        for counts in (sc, sc + k)])


def measure(inputs, iters: int = 10):
    """{input: {"bytes", "bound_ms", "ms": [ms, ms], "empty_lists_ms": [ms,
    ms]}} and one empty kernel's ms twice: bbox_sums timed twice on each
    input and on it with every slot list empty, after a call whose output
    must equal the plain version's."""
    floor = [queued_ms(lambda: torch.cuda._sleep(0), iters)
             for _ in range(2)]
    out = {}
    for name, (args, channels) in inputs.items():
        empty = (args[0], args[1], torch.zeros_like(args[2])) + args[3:]
        res = {"bytes": window_bytes(*args[:4], channels)}
        res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
        for key, a in (("ms", args), ("empty_lists_ms", empty)):
            if not torch.equal(st.bbox_sums(*a), st.bbox_sums_reference(*a)):
                raise SystemExit(f"bbox_sums differs from the plain version "
                                 f"on {name} ({key})")
            res[key] = [queued_ms(lambda: st.bbox_sums(*a), iters)
                        for _ in range(2)]
        out[name] = res
    return out, floor


def main(argv) -> int:
    cases = None
    if "--cases" in argv:
        i = argv.index("--cases")
        if i + 1 >= len(argv):
            raise SystemExit(USAGE)
        cases = argv[i + 1].split(",")
        argv = argv[:i] + argv[i + 2:]
        known = scene.window_case_masks(3, 3)
        if any(c not in known for c in cases):
            raise SystemExit(f"{USAGE}\nwindow cases: {', '.join(known)}")
    if len(argv) > 2 or any(not a.isdigit() for a in argv):
        raise SystemExit(USAGE)
    batch = int(argv[0]) if argv else BATCH
    iters = int(argv[1]) if len(argv) > 1 else 10
    require_card()
    smi = card()
    print(smi, flush=True)
    inputs = make_inputs(*bench_frames(batch), cases=cases)
    torch.cuda.synchronize()
    res, floor = measure(inputs, iters)
    for name, r in res.items():
        for key in ("ms", "empty_lists_ms"):
            ms = r[key]
            print(f"{smi}: {name} {key} "
                  f"{' / '.join(f'{m:.4f}' for m in ms)} ms per {batch} "
                  f"frames ({ms[0] / batch * 1e3:.4f} us/frame); bound "
                  f"{r['bound_ms']:.4f} ms ({r['bytes']} bytes)", flush=True)
    print(f"{smi}: one empty kernel {' / '.join(f'{m:.4f}' for m in floor)}"
          f" ms", flush=True)
    print(json.dumps({"card": smi, "batch": batch, "iters": iters,
                      "cases": cases, "launch_floor_ms": floor,
                      "inputs": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
