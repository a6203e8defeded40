"""The bench scene: synthetic contaminated bottle frames (a copy of the
scene of bench.py, so that the port and chip_smoke.py need nothing of the
JAX package).

Each 640x480 BGR frame is a light background (220) with the bottle's
rectangle outline (100), its base disc (80) and one to three dark
contaminant discs drawn from a seeded RandomState.
"""

import numpy as np

from heimdall_tpu_torch.utils import draw


def scene_params(n, h=480, w=640, seed=0):
    """Per-frame contaminant parameters [n, 3, 4] (x, y, r, v; r=-1 pads),
    drawn from the same RandomState sequence as make_frames."""
    rng = np.random.RandomState(seed)
    p = np.full((n, 3, 4), -1, np.int32)
    for i in range(n):
        for j in range(rng.randint(1, 4)):
            x = rng.randint(w // 4, 3 * w // 4)
            y = rng.randint(h // 4, 3 * h // 4)
            r = rng.randint(4, 16)
            v = int(rng.randint(0, 60))
            p[i, j] = (x, y, r, v)
    return p


def make_frames(n, h=480, w=640, seed=0):
    """[n, h, w, 3] uint8 bench frames (NHWC, BGR)."""
    params = scene_params(n, h, w, seed)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        img = np.full((h, w, 3), 220, np.uint8)
        draw.rect_outline(img, (w // 2 - 100, h // 2 - 120),
                          (w // 2 + 100, h // 2 + 120), (100, 100, 100), 2)
        draw.filled_circle(img, (w // 2, h // 2 + 100), 95, (80, 80, 80))
        for j in range(3):
            x, y, r, v = params[i, j]
            if r >= 0:
                draw.filled_circle(img, (x, y), int(r), (int(v),) * 3)
        frames[i] = img
    return frames


def adversarial_masks(h, w, seed=0):
    """Adversarial boolean masks [h, w] for the labeling and hole-fill
    paths, by name: dense noise (more blobs than any table holds), one long
    spiral arm (and its spiral background corridor), nested rings with a
    blob in the innermost hole, and blobs cut by every frame edge."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r = np.hypot(yy - cy, xx - cx)
    s = min(h, w)
    pitch = max(s / 24.0, 4.0)
    arm = max(pitch / 2.0, 2.0)
    th = np.mod(np.arctan2(yy - cy, xx - cx), 2 * np.pi)
    u = r / pitch - th / (2 * np.pi)
    k = np.rint(u)
    spiral = (np.abs(u - k) * pitch < arm / 2.0) & (k >= 1) & (
        r < 0.48 * s)
    ring_w = max(s / 16.0, 3.0)
    rings = np.zeros((h, w), bool)
    for i in (1, 2, 3):
        r0 = i * 2.5 * ring_w
        rings |= (r >= r0) & (r < r0 + ring_w)
    rings |= r < 0.8 * ring_w
    edges = np.zeros((h, w), bool)
    rad = max(s / 10.0, 3.0)
    for py, px in ((0, w / 3), (h - 1, 2 * w / 3), (h / 2, 0),
                   (h / 3, w - 1), (0, 0), (h - 1, w - 1)):
        edges |= np.hypot(yy - py, xx - px) <= rad
    return {"noise": rng.rand(h, w) < 0.5, "spiral": spiral,
            "rings": rings, "edges": edges}


def mask_frames(masks):
    """Stack boolean masks into dark-on-light BGR frames [n, h, w, 3]."""
    out = []
    for m in masks:
        img = np.full(m.shape + (3,), 230, np.uint8)
        img[m] = 20
        out.append(img)
    return np.stack(out)


def non_root_labels(labels):
    """A label plane whose labels need not name a root, for the stats
    kernel's checks, from a labeling's int32 tensor [B, H, W] (background
    H*W, roots hold their own linear index).  In each frame with 6 roots or
    more: the 2nd component relabelled to a background pixel's index, the
    3rd to a non-root pixel of the 1st, the 4th's root pixel to the 1st
    root's index (the rest of the 4th then names no root), and the 5th to
    the 6th's root (members above their root's row)."""
    import torch

    out = labels.clone()
    HW = out.shape[-2] * out.shape[-1]
    for b in range(out.shape[0]):
        lab = out[b].reshape(-1)
        roots = torch.nonzero(lab == torch.arange(HW, device=lab.device))
        roots = roots.flatten().tolist()
        if len(roots) < 6:
            continue
        bg = int(torch.nonzero(lab == HW)[0])
        first = torch.nonzero(lab == roots[0]).flatten().tolist()
        lab[lab == roots[1]] = bg
        if len(first) > 1:
            lab[lab == roots[2]] = first[-1]
        lab[roots[3]] = roots[0]
        lab[lab == roots[4]] = roots[5]
    return out


def check_runtable_masks(h=96, w=128):
    """The masks of the run-table check (a copy of the cases of
    scripts/check_runtable.py), u8 [h, w] by name: a hollow rectangle with a
    disc and a speck (the bench scene's structure), a diagonal chain of
    corner-touching squares, a spiral, random discs (RandomState(3)), a row
    band of 20 runs (more runs than any table holds: the frame falls back),
    an empty and a full mask."""
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:h, 0:w]
    cases = {}
    m = np.zeros((h, w), np.uint8)
    m[10:80, 20:22] = 1
    m[10:80, 100:102] = 1
    m[10:12, 20:102] = 1
    m[78:80, 20:102] = 1
    m |= ((yy - 50) ** 2 + (xx - 60) ** 2 <= 15 ** 2).astype(np.uint8)
    m |= ((yy - 30) ** 2 + (xx - 40) ** 2 <= 4 ** 2).astype(np.uint8)
    cases["rect+disc+speck"] = m
    m = np.zeros((h, w), np.uint8)
    for i in range(30):
        m[10 + 2 * i: 12 + 2 * i, 10 + 2 * i: 12 + 2 * i] = 1
    cases["diag chain"] = m
    m = np.zeros((h, w), np.uint8)
    t = np.linspace(0, 5 * np.pi, 3000)
    r = 2 + t * 2.0
    sy = np.clip((48 + r * np.sin(t)).astype(int), 0, h - 1)
    sx = np.clip((64 + r * np.cos(t)).astype(int), 0, w - 1)
    m[sy, sx] = 1
    m[np.clip(sy + 1, 0, h - 1), sx] = 1
    cases["spiral"] = m
    m = np.zeros((h, w), np.uint8)
    for _ in range(10):
        cy, cx = rng.randint(3, h - 3), rng.randint(3, w - 3)
        rr = rng.randint(1, 9)
        m |= ((yy - cy) ** 2 + (xx - cx) ** 2 <= rr * rr).astype(np.uint8)
    cases["random"] = m
    m = np.zeros((h, w), np.uint8)
    for k in range(20):
        m[40:44, 4 + 6 * k: 7 + 6 * k] = 1
    cases["overflow->fallback"] = m
    cases["empty"] = np.zeros((h, w), np.uint8)
    cases["full"] = np.ones((h, w), np.uint8)
    return cases
