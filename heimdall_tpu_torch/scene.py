"""The bench scene: synthetic contaminated bottle frames (a copy of the
scene of bench.py, so that the port and chip_smoke.py need nothing of the
JAX package).

Each 640x480 BGR frame is a light background (220) with the bottle's
rectangle outline (100), its base disc (80) and one to three dark
contaminant discs drawn from a seeded RandomState.  Beside it: the
adversarial masks, the run-table check's masks, and the masks and frames
that attack the 2 MP kernels' tiles (tile_case_masks, tile_case_frames),
the masks that attack the labeling's tiles (label_case_masks), the
run-table cases (run_case_masks, fix_case_masks), the masks whose bbox
windows attack the bbox-window sums (window_case_masks), the label planes
that attack the stats kernel from a label plane (stats_case_labels) and a
maze whose corridor crosses a shard's cut row twice (cut_maze_mask),
shared by the tests and chip_smoke.py.
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


def cut_maze_mask(h, w, cut):
    """A foreground mask [h, w] with a background corridor from the left
    border that crosses row ``cut`` down and back up again and ends in a
    dead end above it, and a one-pixel hole: cut there, the shard above
    reaches the dead end only through the shard below (3 <= cut <= h - 3,
    w >= 9)."""
    m = np.ones((h, w), bool)
    top, low = max(cut - 4, 1), min(cut + 3, h - 2)
    m[top, :w // 3 + 1] = False                  # from the border
    m[top:low + 1, w // 3] = False               # down across the cut
    m[low, w // 3:2 * w // 3 + 1] = False
    m[top:low + 1, 2 * w // 3] = False           # back up across it
    m[top, 2 * w // 3:w - 3] = False             # dead end
    m[low - 1, 3] = False                        # a hole
    return m


# The sizes at which the stats kernel's cases are checked on the card.
STATS_CASE_SIZES = ((480, 640), (477, 631), (13, 17), (3, 3))


def _labels_from_roots(h, w, roots, rng, p_bg=0.3, p_far=0.15,
                       p_none=0.1):
    """An int32 label plane [h, w] whose roots (pixels labelled with their
    own index) are exactly ``roots``: each other pixel is background (h*w)
    with probability p_bg, else it names a random root (p_far; maybe one
    ranked K or later), a random pixel (p_none; mostly no root), or the
    last root at or before it in raster order (background before the
    first root)."""
    hw = h * w
    roots = np.unique(np.asarray(roots, np.int64))
    p = np.arange(hw)
    at = np.searchsorted(roots, p, side="right") - 1
    lab = np.where(at >= 0, roots[np.maximum(at, 0)], hw)
    u = rng.rand(hw)
    if len(roots):
        lab = np.where(u < p_far, roots[rng.randint(0, len(roots), hw)], lab)
    lab = np.where((u >= p_far) & (u < p_far + p_none),
                   rng.randint(0, hw, hw), lab)
    lab = np.where(u > 1 - p_bg, hw, lab)
    is_root = np.zeros(hw, bool)
    is_root[roots] = True
    lab[(lab == p) & ~is_root] = hw      # only the roots name themselves
    lab[roots] = roots
    return lab.reshape(h, w).astype(np.int32)


def stats_case_labels(h, w, k, seed=0):
    """Label planes that attack the stats kernel from a label plane (B6a)
    at K = k, by name (int32 [h, w], background h*w):

    * background, foreground: no pixel labelled; every pixel labelled 0
      (one root);
    * kth_root_mid_row: the k-th root (rank k - 1) in the middle of row h //
      2 and the (k+1)-th right beside it, with k - 1 roots before and up to
      k after;
    * more_roots_than_k: 3 k + 7 roots (or every pixel) anywhere;
    * last_row_root: a root in the middle of the last row;
    * every_pixel_a_root: each pixel's label its own index;
    * non_root_labels: 5 roots, half of the other pixels naming a random
      pixel.

    Other pixels of the rooted cases are as _labels_from_roots draws them:
    labels of roots ranked k or later, of non-roots and of roots in rows
    below."""
    rng = np.random.RandomState(seed)
    hw = h * w

    def pick(lo, hi, n):
        """n distinct pixels of [lo, hi), or all of them."""
        return lo + rng.choice(hi - lo, size=min(n, hi - lo), replace=False)

    mid = (h // 2) * w + w // 2
    last = (h - 1) * w + w // 2
    kth = np.concatenate([pick(0, mid, k - 1), [mid, mid + 1],
                          pick(mid + 2, hw, k - 1)])
    return {
        "background": np.full((h, w), hw, np.int32),
        "foreground": np.zeros((h, w), np.int32),
        "kth_root_mid_row": _labels_from_roots(h, w, kth, rng),
        "more_roots_than_k": _labels_from_roots(h, w,
                                                pick(0, hw, 3 * k + 7), rng),
        "last_row_root": _labels_from_roots(
            h, w, np.concatenate([pick(0, last, k // 2), [last]]), rng,
            p_bg=0.6),
        "every_pixel_a_root": np.arange(hw, dtype=np.int32).reshape(h, w),
        "non_root_labels": _labels_from_roots(h, w, pick(0, hw, 5), rng,
                                              p_far=0.1, p_none=0.5),
    }


def stats_case_frames(n, h, w, seed=0):
    """n random BGR frames as planes [n, 3, h, w] uint8 for the stats
    cases."""
    return np.random.RandomState(seed).randint(0, 256, (n, 3, h, w),
                                               dtype=np.uint8)


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


# The tiles (rows, columns) of the hole-fill kernel, of the foreground
# labeling and of the one-pass preprocess (csrc/tile_uf.cuh,
# csrc/fused_detect.cu).
FILL_TILE = (32, 128)
LABEL_TILE = (32, 128)
PRE_TILE = (64, 120)
# Frame sizes that cut tiles or are smaller than a tile or the preprocess's
# 11-pixel halo.
TILE_CASE_SIZES = ((3, 3), (3, 1920), (1080, 3), (13, 17), (1037, 1531))


def _spiral_corridor(h, w, open_to_border):
    """All foreground but a one-pixel background corridor that winds from
    (1, 1) inward in a square spiral, walls one pixel thick; with
    open_to_border it starts at the frame's left edge."""
    m = np.ones((h, w), bool)
    if h < 3 or w < 3:
        return m
    y, x = 1, 1
    m[y, x] = False
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    d, turns = 0, 0
    while turns < 4:
        dy, dx = dirs[d]
        ny, nx = y + 2 * dy, x + 2 * dx
        if 1 <= ny <= h - 2 and 1 <= nx <= w - 2 and m[ny, nx]:
            m[y + dy, x + dx] = m[ny, nx] = False
            y, x, turns = ny, nx, 0
        else:
            d, turns = (d + 1) % 4, turns + 1
    if open_to_border:
        m[1, 0] = False
    return m


def _snake_corridor(h, w, tile, open_to_border):
    """All foreground but a one-pixel background corridor that runs along
    every horizontal tile edge (rows Y - 1 and Y), stepping from one side of
    the edge to the other at every tile column edge X, through the corner
    (Y - 1, X - 1), (Y - 1, X), (Y, X); the edges are joined in a serpentine
    at columns 1 and w - 2.  With open_to_border it starts at the frame's
    left edge."""
    th, tw = tile
    m = np.ones((h, w), bool)
    if h < 3 or w < 3:
        return m
    edges = [y for y in range(th, h - 1, th)] or [h // 2]
    prev_end = None
    for k, Y in enumerate(edges):
        row = Y - 1 if Y >= 1 else Y
        xs = range(1, w - 1) if k % 2 == 0 else range(w - 2, 0, -1)
        start = xs[0]
        if prev_end is not None:        # the serpentine's vertical connector
            m[prev_end[0]:row + 1, start] = False
        for x in xs:
            m[row, x] = False
            if x % tw == 0 and x not in (1, w - 2) and Y < h - 1:
                nxt = row + 1 if row == Y - 1 else row - 1
                m[nxt, x] = False
                row = nxt
        prev_end = (row, xs[-1])
    if open_to_border:
        m[edges[0] - 1 if edges[0] >= 1 else edges[0], 0] = False
    return m


def _diagonal_corners(h, w, tile):
    """All foreground but, at every interior tile corner (Y, X), the two
    background pixels (Y - 1, X - 1) and (Y, X), which touch only
    diagonally; at the first row of corners the first of the two is joined
    to the top edge by a corridor up column X - 1, so the second must stay
    a hole under 4-connectivity."""
    th, tw = tile
    m = np.ones((h, w), bool)
    for Y in range(th, h - 1, th):
        for X in range(tw, w - 1, tw):
            m[Y - 1, X - 1] = m[Y, X] = False
            if Y == th:
                m[:Y, X - 1] = False
    return m


def tile_case_masks(h, w, seed=0, tile=FILL_TILE):
    """Masks that attack the tiles of the hole fill, bool [h, w] by name
    (True = foreground): a background spiral corridor, closed and open to
    the border; a one-pixel corridor snaking across every tile edge and
    corner, closed and open; background pixels meeting at tile corners only
    diagonally; all foreground; all background; and uniform noise."""
    rng = np.random.RandomState(seed)
    return {
        "spiral_closed": _spiral_corridor(h, w, False),
        "spiral_open": _spiral_corridor(h, w, True),
        "snake_closed": _snake_corridor(h, w, tile, False),
        "snake_open": _snake_corridor(h, w, tile, True),
        "diagonal_corners": _diagonal_corners(h, w, tile),
        "all_fg": np.ones((h, w), bool),
        "all_bg": np.zeros((h, w), bool),
        "noise": rng.rand(h, w) < 0.5,
    }


def _corner_pixels(h, w, tile, anti):
    """Background but, at every interior tile corner (Y, X), the two
    foreground pixels (Y - 1, X - 1) and (Y, X) (anti: (Y - 1, X) and
    (Y, X - 1)), which touch only diagonally."""
    th, tw = tile
    m = np.zeros((h, w), bool)
    for Y in range(th, h, th):
        for X in range(tw, w, tw):
            if anti:
                m[Y - 1, X] = m[Y, X - 1] = True
            else:
                m[Y - 1, X - 1] = m[Y, X] = True
    return m


def _hook(h, w, tile):
    """A component whose least pixel lies in a later tile than the
    component's pixels of an earlier row: an arm down the first tile
    column from row 10, an arm down the last from row 3, joined by a bar
    near the bottom; and a U whose two arms lie in the first tile, joined
    only below it, in the next tile row."""
    th, tw = tile
    m = np.zeros((h, w), bool)
    if h < 8 or w < 8:
        return m
    bottom, a, b = h - 3, min(5, w - 1), w - 2
    m[min(10, bottom):bottom + 1, a] = True
    m[3:bottom + 1, b] = True
    m[bottom, a:b + 1] = True
    if h > th + 10 and w > 30:
        u = th + 8
        m[2:u + 1, 10] = m[2:u + 1, 20] = True
        m[u, 10:21] = True
    return m


def label_case_masks(h, w, seed=0, tile=LABEL_TILE):
    """Masks that attack the foreground labeling's tiles, bool [h, w] by
    name (True = foreground): a one-pixel corridor snaking across every
    tile edge and corner, a spiral corridor and its walls, foreground
    pixels meeting only diagonally at tile corners (both diagonals: one
    component under 8-connectivity, two under 4), a component whose least
    pixel lies in a later tile than its first rows' tiles (and a U joined
    only in the next tile row), all foreground, all background, and noise
    at 0.5 (more roots a band than a root table holds)."""
    rng = np.random.RandomState(seed)
    return {
        "snake": ~_snake_corridor(h, w, tile, False),
        "spiral": ~_spiral_corridor(h, w, False),
        "spiral_walls": _spiral_corridor(h, w, False),
        "diagonal_corners": _corner_pixels(h, w, tile, False),
        "antidiagonal_corners": _corner_pixels(h, w, tile, True),
        "hook": _hook(h, w, tile),
        "all_fg": np.ones((h, w), bool),
        "all_bg": np.zeros((h, w), bool),
        "noise": rng.rand(h, w) < 0.5,
    }


def tile_case_frames(h, w, seed=0, tile=PRE_TILE):
    """BGR frames u8 [h, w, 3] that attack the preprocess's tiles, by name:
    uniform noise (the threshold flips most often), a uniform gray frame
    (all background at contrast 15, all foreground at contrast -15), and
    the spiral, snake and corner masks of tile_case_masks drawn dark on
    light."""
    rng = np.random.RandomState(seed)
    masks = tile_case_masks(h, w, seed, tile)
    names = ("spiral_open", "snake_closed", "diagonal_corners")
    drawn = mask_frames([masks[n] for n in names])
    out = {"noise": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
           "uniform": np.full((h, w, 3), 128, np.uint8)}
    out.update(zip(names, drawn))
    return out


# The run extraction's seams (csrc/runtable_tiled.cu): a lane takes 16
# columns of a row, a warp step 512.
RUN_LANE_COLS = 16
RUN_STEP_COLS = 512
RUN_SEAMS = (RUN_LANE_COLS, 2 * RUN_LANE_COLS, RUN_STEP_COLS,
             2 * RUN_STEP_COLS, 3 * RUN_STEP_COLS)
# Rows of a few frames at widths below a lane, across one, odd and the 2 MP
# width.
RUN_CASE_SIZES = ((5, 1), (5, 3), (5, 17), (5, 531), (5, 1920))
# Runs a row of the counted cases holds: R and R + 1 for the tables'
# widths (the detector's 8 / 7, the tests' 12 / 10).
RUN_COUNTS = (6, 7, 8, 9, 10, 11, 12, 13)
RUN_SHIFTS = 17


def _runs_row(w, runs, shift):
    """bool [w]: True on the columns of runs [(first, last), ...], each
    moved right by shift and cut at the row's end."""
    row = np.zeros(w, bool)
    for a, b in runs:
        row[max(a + shift, 0):max(b + shift + 1, 0)] = True
    return row


def run_case_masks(h, w):
    """Masks that attack the run extraction's lanes and steps, bool [h, w]
    by name (True = foreground).  Row y is the case's row moved right by
    y % 17 columns, so that every run edge meets a seam from both sides:
    runs ending at, starting at and crossing the lane and step edges
    (RUN_SEAMS), every other lane's 16 columns, a run through the whole
    row but its first and last column, one-pixel runs on every second
    column from column 0 and from column 1 (960 runs at w = 1920: runid
    wraps past 255), rows of exactly k runs for each k of RUN_COUNTS, all
    foreground and all background."""
    spaced = {}
    for k in RUN_COUNTS:
        gap = max(2, w // k)
        spaced[f"runs_{k}"] = [(j * gap, j * gap + max(0, gap // 2 - 1))
                               for j in range(k)]
    cases = {
        "ends_at_seams": [(s - 4, s - 1) for s in RUN_SEAMS],
        "starts_at_seams": [(s, s + 3) for s in RUN_SEAMS],
        "across_seams": [(s - 1, s) for s in RUN_SEAMS],
        "lane_blocks": [(c, c + RUN_LANE_COLS - 1)
                        for c in range(0, w, 2 * RUN_LANE_COLS)],
        "through_row": [(1, w - 2)],
        "alternate_even": [(c, c) for c in range(0, w, 2)],
        "alternate_odd": [(c, c) for c in range(1, w, 2)],
        **spaced,
    }
    out = {name: np.stack([_runs_row(w, runs, y % RUN_SHIFTS)
                           for y in range(h)])
           for name, runs in cases.items()}
    out["all_fg"] = np.ones((h, w), bool)
    out["all_bg"] = np.zeros((h, w), bool)
    return out


# Frame sizes of the union-find cases (fix_case_masks) on the card: the 2 MP
# size, an odd one, and heights of 1 row and just below, at and above the 8
# blocks of a frame's cluster (csrc/runtable_tiled.cu: blocks with no rows).
FIX_CASE_SIZES = ((1080, 1920), (301, 517), (1, 517), (7, 517), (8, 517),
                  (9, 517))
FIX_TEETH = 6


def _bars(w, k):
    """Column ranges [(a, b), ...] of k bars and the k + 1 gaps around them,
    of nearly equal width (at least one column each where w >= 2k + 1)."""
    edges = np.linspace(0, w, 2 * k + 2).astype(int)
    return [(edges[2 * j + 1], max(edges[2 * j + 2], edges[2 * j + 1] + 1))
            for j in range(k)]


def _serpentine(h, w, inner):
    """Four vertical corridors joined at alternate ends: the first two at
    the bottom, the middle two at the top, the last two at the bottom.
    inner: the corridors run over rows 1 .. h - 2 (the joins on those rows),
    else over every row."""
    m = np.zeros((h, w), bool)
    top, bottom = (1, h - 2) if inner else (0, h - 1)
    if bottom < top:
        return m
    bars = _bars(w, 4)
    for a, b in bars:
        m[top:bottom + 1, a:b] = True
    for (a, _), (_, b), row in ((bars[0], bars[1], bottom),
                                (bars[1], bars[2], top),
                                (bars[2], bars[3], bottom)):
        m[row, a:b] = True
    return m


def _staircase(h, w, top):
    """A diagonal from row `top` to the last row, the run of row y starting
    at y * (w - t) / h with t columns, enough for each row's run to overlap
    the next one's."""
    m = np.zeros((h, w), bool)
    step = (w - 1) / max(h, 1)
    t = min(w, int(np.ceil(step)) + 2)
    for y in range(top, h):
        x = int(y * (w - t) / max(h - 1, 1))
        m[y, x:x + t] = True
    return m


def _comb(h, w, top):
    """FIX_TEETH vertical teeth from row `top` to the last row, joined only
    on the last row."""
    m = np.zeros((h, w), bool)
    bars = _bars(w, FIX_TEETH)
    for a, b in bars:
        m[top:, a:b] = True
    m[h - 1, bars[0][0]:bars[-1][1]] = True
    return m


def fix_case_masks(h, w):
    """Masks whose components cross every block edge of the run-table
    union-finds (a frame split into row blocks) many times, yet whose rows
    fit the detector's tables (at most 8 background and 7 filled foreground
    runs), bool [h, w] by name (True = foreground):

    * serpentine: four foreground corridors over every row, joined at
      alternate ends (one component from top to bottom); serpentine_bg_open
      the same corridors as background in foreground over rows 1 .. h - 2,
      reaching the border only through the top of the last corridor;
      serpentine_bg_closed not at all (a hole);
    * ring: a closed foreground ring over every row, its hole spanning the
      frame's height;
    * staircase: a foreground diagonal that crosses each row block's edge
      once; staircase_bg the same as background in foreground from row 1,
      reaching the border only on the last row;
    * comb: FIX_TEETH foreground teeth over every row, meeting only on the
      last row; comb_bg the same as background in foreground from row 1,
      reaching the border only through the last row."""
    ring = np.zeros((h, w), bool)
    a, b = w // 4, max(3 * w // 4, w // 4 + 1)
    t = max(1, w // 64)
    ring[:, a:min(a + t, b)] = ring[:, max(b - t, a):b] = True
    ring[0, a:b] = ring[h - 1, a:b] = True
    serpentine_open = _serpentine(h, w, True)
    if h >= 3:
        a3, b3 = _bars(w, 4)[3]
        serpentine_open[0, a3:b3] = True
    return {
        "serpentine": _serpentine(h, w, False),
        "serpentine_bg_open": ~serpentine_open,
        "serpentine_bg_closed": ~_serpentine(h, w, True),
        "ring": ring,
        "staircase": _staircase(h, w, 0),
        "staircase_bg": ~_staircase(h, w, min(1, h - 1)),
        "comb": _comb(h, w, 0),
        "comb_bg": ~_comb(h, w, min(1, h - 1)),
    }


# Rows on which window_case_masks puts band edges: each is a band's first
# row for bands of 16, 2 and 1 rows, and the multiples of 128 also for the
# detector's band of 128.
WINDOW_EDGES = (16, 32)
WINDOW_BAND = 128


def window_case_masks(h, w):
    """Masks whose blobs' bbox windows attack the bbox-window sums (a window
    walked a row at a time, its rows dealt out per band), bool [h, w] by
    name (True = foreground; h, w >= 3):

    * whole: one blob over the whole frame, one window over every band;
    * disk: a filled disk of radius 0.37 h about the centre, whose window
      spans every band of 128 rows but the first and the last at 1080 rows;
    * columns: one-pixel-wide columns on column 0 and column w - 1 from the
      first row to the last;
    * corners: one-pixel blobs in the four corners;
    * band_edges: at each row e of WINDOW_EDGES and the multiples of
      WINDOW_BAND below h, a 2-column blob whose top row is e and one whose
      bottom row is e - 1, and one blob over rows 16 .. 31 (a band of 16
      exactly);
    * crowded: one-pixel blobs on every other column of the middle row,
      more blobs in one band than the slots of the lists (ceil(w / 2));
    * empty: no blob."""
    yy, xx = np.mgrid[:h, :w]
    radius = max(1, int(0.37 * h))
    disk = (yy - h // 2) ** 2 + (xx - w // 2) ** 2 <= radius ** 2
    columns = np.zeros((h, w), bool)
    columns[:, [0, w - 1]] = True
    corners = np.zeros((h, w), bool)
    corners[[0, 0, h - 1, h - 1], [0, w - 1, 0, w - 1]] = True
    edges = np.zeros((h, w), bool)
    rows = sorted(set(WINDOW_EDGES) | set(range(WINDOW_BAND, h,
                                                WINDOW_BAND)))
    x = 1
    for e in (r for r in rows if r < h):
        if x + 6 > w:
            break
        edges[e:e + 3, x:x + 2] = True              # top row on the edge
        edges[max(e - 3, 0):e, x + 4:x + 6] = True  # bottom row above it
        x += 8
    if h >= 32 and x + 2 <= w:
        edges[16:32, x:x + 2] = True
    crowded = np.zeros((h, w), bool)
    crowded[h // 2, ::2] = True
    return {
        "whole": np.ones((h, w), bool),
        "disk": disk,
        "columns": columns,
        "corners": corners,
        "band_edges": edges,
        "crowded": crowded,
        "empty": np.zeros((h, w), bool),
    }


# The sweep fill's words (csrc/fill_sweeps.cu): a row is held as words of
# 32 columns.  Sizes of the bit cases: widths one under, at and one over a
# word and one past 640, heights past the 31 rows of the TPU ladder's
# column reach.
BIT_WORD = 32
BIT_CASE_SIZES = ((40, 31), (40, 32), (40, 33), (70, 641))
SNAKE_LEGS = 8


def _word_runs(h, w):
    """Foreground but, on every other row from row 2, background runs that
    end on a word's last column, start on a word's first column, cross a
    word edge, run through the whole row (touching both sides of the frame)
    or through all but its first and last columns, and on alternate
    columns; the rows between stay foreground, so each run is a hole unless
    it touches the frame's side."""
    m = np.ones((h, w), bool)
    for i, y in enumerate(range(2, h - 2, 2)):
        kind = i % 6
        for k in range(-(-w // BIT_WORD)):
            x0 = k * BIT_WORD
            if kind == 0:                       # ends on bit 31
                m[y, x0 + 16:x0 + BIT_WORD] = False
            elif kind == 1:                     # starts on bit 0
                m[y, x0:x0 + 15] = False
            elif kind == 2:                     # crosses the word edge
                m[y, x0 + 20:x0 + 45] = False
        if kind == 3:
            m[y, :] = False
        elif kind == 4:
            m[y, 1:w - 1] = False
        elif kind == 5:
            m[y, 1::2] = False
    return m


def _column_snake(h, w, open_to_border):
    """Foreground but a one-pixel background corridor of SNAKE_LEGS legs
    down and up alternate columns (from column 24, across the word edge at
    32, where the frame is 48 wide; else from column 2), each from row 1 to
    row h - 2, joined at alternate ends: each leg longer than 31 rows when
    h > 33.  With open_to_border it starts at the top edge."""
    m = np.ones((h, w), bool)
    if h < 4 or w < 4:
        return m
    start = 24 if w >= 48 else 2
    cols = list(range(start, w - 2, 2))[:SNAKE_LEGS]
    for i, x in enumerate(cols):
        m[1:h - 1, x] = False
        if i + 1 < len(cols):
            y = h - 2 if i % 2 == 0 else 1
            m[y, x:cols[i + 1] + 1] = False
    if open_to_border and cols:
        m[0, cols[0]] = False
    return m


def _edge_holes(h, w, opened):
    """Foreground but background runs along row 1, row h - 2, column 1 and
    column w - 2, each a hole against the frame's edge; with `opened` each
    run also reaches the edge through one pixel."""
    m = np.ones((h, w), bool)
    if h < 7 or w < 7:
        return m
    m[1, 2:w - 2] = m[h - 2, 2:w - 2] = False
    m[3:h - 3, 1] = m[3:h - 3, w - 2] = False
    if opened:
        m[0, w // 2] = m[h - 1, w // 2] = False
        m[h // 2, 0] = m[h // 2, w - 1] = False
    return m


def _word_stripes(h, w):
    """Background stripes of whole words (columns 32k .. 32k + 31 for even
    k) from row 2 to row h - 2, under two foreground rows and over one: the
    first stripe touches the frame's left side, a last one on column w - 1
    its right side, the others are holes."""
    m = np.ones((h, w), bool)
    if h < 5:
        return m
    xx = np.arange(w)
    m[2:h - 1, (xx // BIT_WORD) % 2 == 0] = False
    return m


def bit_case_masks(h, w):
    """Masks that attack the sweep fill's bit words, bool [h, w] by name
    (True = foreground): background runs ending on bit 31, starting on bit
    0, crossing words, through a whole row and on alternate columns
    (word_runs); a corridor snaking down and up columns through more than
    31 rows, closed and open (snake_closed, snake_open); holes against the
    first and last rows and columns, closed and opened through one pixel
    (edge_holes, edge_open); background stripes of whole words
    (word_stripes); all foreground and all background.  At
    BIT_CASE_SIZES."""
    return {
        "word_runs": _word_runs(h, w),
        "snake_closed": _column_snake(h, w, False),
        "snake_open": _column_snake(h, w, True),
        "edge_holes": _edge_holes(h, w, False),
        "edge_open": _edge_holes(h, w, True),
        "word_stripes": _word_stripes(h, w),
        "all_fg": np.ones((h, w), bool),
        "all_bg": np.zeros((h, w), bool),
    }


def bit_case_frames(h, w):
    """BGR frames u8 [n, h, w, 3] of bit_case_masks drawn dark on light
    (mask_frames), in bit_case_masks' order: the label kernel's stages and
    the fill probes on them."""
    return mask_frames(list(bit_case_masks(h, w).values()))


def ring_frames(n, h, w, seed=0):
    """[n, h, w, 3] uint8 frames for the contamination inspector: dark
    rings (0-39) with light centres (150-255) on a light ground (215), one
    for every 5,000 pixels (at least 2).  The inspector's pipeline turns a
    ring into a white annulus around a black hole, which its detector then
    finds as a defect; the bench and simulation frames give it few."""
    rng = np.random.RandomState(seed)
    frames = np.full((n, h, w, 3), 215, np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(max(2, h * w // 5000)):
            y, x = rng.randint(14, h - 14), rng.randint(14, w - 14)
            r = rng.randint(8, 14)
            d = (yy - y) ** 2 + (xx - x) ** 2
            frames[i][d <= r * r] = rng.randint(0, 40)
            frames[i][d <= (r - 5) ** 2] = rng.randint(150, 256)
    return frames
