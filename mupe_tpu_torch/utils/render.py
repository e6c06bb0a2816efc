"""Arena rendering for evaluation videos (counterpart of
mupe_tpu/utils/render.py), in numpy alone.

The JAX package draws each frame with matplotlib (Agg) and writes the GIF
with PIL.  The port depends on neither: it rasterises JAX's layout itself
and writes GIF89a with its own LZW encoder.  The frame is JAX's (576 x 324
RGB at dpi 72, a top-down panel and a side elevation, each with a 1-px
frame and a title), its artists in JAX's z-order, with three differences
that keep every pixel a colour of one fixed palette (`PALETTE`):

* nothing is antialiased: a pixel takes an artist's colour where its
  centre lies inside the artist (discs, rings, the star, rectangles) or
  where a point sampled every half pixel along a line falls in it;
* the trails' alpha 0.5 and the catch circles' alpha 0.7 are tints of
  their colour over white;
* the titles are drawn with a built-in 5 x 7 bitmap font covering the
  characters they use (`t=`, the digits, `side`, and `CAPTURED`).

Frames are drawn as palette indices (`render_index_frame`,
`index_trajectory`) and returned as RGB; `episode_video` encodes the
indices without the round trip.  `save_gif` writes every frame after the
first as the sub-rectangle of the pixels that changed (disposal "do not
dispose") and encodes each with a greedy LZW whose longest match is found
by galloping over the prefix-closed code table (`_lzw_codes`): its cost
follows the number of codes, not of pixels.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

_DRONE_COLORS = ("#1f77b4", "#2ca02c", "#9467bd", "#8c564b")
_RED, _BLUE, _ORANGE = "#d62728", "#1f77b4", "#ff7f0e"

# ------------------------------------------------------------------ layout
# JAX's figure: figsize (8, 4.5) inches, width ratios (1, 0.45), then
# `fig.tight_layout()`.  Each panel's axes box in display pixels at dpi 72
# (origin at the bottom left; x0, y0, width, height), read off
# `ax.get_window_extent()` of JAX's figure with matplotlib 3.10.8
# (tests/test_torch_render.py recomputes them where matplotlib imports).
# Other dpis scale them.
_FIG_INCHES = (8.0, 4.5)
_BOX_TOP = (52.357691, 10.8, 286.4, 286.4)       # square: set_aspect("equal")
_BOX_SIDE = (398.918078, 10.8, 166.281922, 286.4)
_LIM_SCALE = 1.15              # the top-down panel spans +-1.15 arena_size
_SIDE_Y = (-0.05, 1.2)         # the side panel's y: -0.05 to 1.2 max_height
# sizes in points (1 pt = 1 px at dpi 72), as JAX's artists and
# matplotlib's defaults give them
_MEW = 1.0                     # lines.markeredgewidth: a marker's outline
_DOT_MS, _SIDE_DOT_MS = 7.0, 6.0
_STAR_MS, _SIDE_STAR_MS = 14.0, 12.0
_X_MS = 5.0
_ARENA_LW, _CATCH_LW, _PRED_LW, _HLINE_LW = 1.5, 0.8, 1.5, 1.0  # the trails' 0.8: 1 px
_DASHED = (3.7, 1.6)           # "--" (on, off) in line widths
_DOTTED = (1.0, 1.65)          # ":"
_STAR_INNER = 0.381966         # Path.unit_regular_star(5)'s inner radius
_TITLE_PAD = 6.0               # axes.titlepad: the title's baseline above the frame


def _rgb(spec: str, alpha: float = 1.0) -> tuple:
    """A colour "#rrggbb" or a grey level "0.65" as 8-bit RGB, at `alpha`
    over white (rounded as Agg rounds: half up)."""
    if spec.startswith("#"):
        c = [int(spec[i:i + 2], 16) / 255.0 for i in (1, 3, 5)]
    else:
        c = [float(spec)] * 3
    return tuple(int((alpha * v + (1.0 - alpha)) * 255.0 + 0.5) for v in c)


# the palette: index -> RGB; every pixel of a rendered frame is one of these
_COLORS = {
    "white": _rgb("1.0"), "black": _rgb("0.0"), "arena": _rgb("0.4"),
    "cylinder": _rgb("0.65"), "column": _rgb("0.85"),
    **{f"drone{i}": _rgb(c) for i, c in enumerate(_DRONE_COLORS)},
    "red": _rgb(_RED), "orange": _rgb(_ORANGE),
    **{f"trail{i}": _rgb(c, 0.5) for i, c in enumerate(_DRONE_COLORS)},
    "target_trail": _rgb(_RED, 0.5),
    "catch_captured": _rgb(_RED, 0.7), "catch": _rgb(_BLUE, 0.7),
}
_IDX = {name: i for i, name in enumerate(_COLORS)}
PALETTE = np.array(list(_COLORS.values()), dtype=np.uint8)       # [P, 3]
_GIF_TABLE_BITS = 5                    # a 32-entry global colour table

# 5 x 7 glyphs of the titles' characters (others are drawn as blanks)
_GLYPHS = {
    "0": (".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."),
    "1": ("..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."),
    "2": (".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"),
    "3": ("####.", "....#", "....#", ".###.", "....#", "....#", "####."),
    "4": ("...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."),
    "5": ("#####", "#....", "####.", "....#", "....#", "#...#", ".###."),
    "6": ("..##.", ".#...", "#....", "####.", "#...#", "#...#", ".###."),
    "7": ("#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."),
    "8": (".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."),
    "9": (".###.", "#...#", "#...#", ".####", "....#", "...#.", ".##.."),
    "t": (".#...", ".#...", "####.", ".#...", ".#...", ".#..#", "..##."),
    "=": (".....", ".....", "#####", ".....", "#####", ".....", "....."),
    "s": (".....", ".....", ".####", "#....", ".###.", "....#", "####."),
    "i": ("..#..", ".....", ".##..", "..#..", "..#..", "..#..", ".###."),
    "d": ("....#", "....#", ".####", "#...#", "#...#", "#...#", ".####"),
    "e": (".....", ".....", ".###.", "#...#", "#####", "#....", ".###."),
    " ": (".....",) * 7,
    # render_frame's own title where none is given and the pursuers caught
    "C": (".###.", "#...#", "#....", "#....", "#....", "#...#", ".###."),
    "A": (".###.", "#...#", "#...#", "#####", "#...#", "#...#", "#...#"),
    "P": ("####.", "#...#", "#...#", "####.", "#....", "#....", "#...."),
    "T": ("#####", "..#..", "..#..", "..#..", "..#..", "..#..", "..#.."),
    "U": ("#...#", "#...#", "#...#", "#...#", "#...#", "#...#", ".###."),
    "R": ("####.", "#...#", "#...#", "####.", "#.#..", "#..#.", "#...#"),
    "E": ("#####", "#....", "#....", "####.", "#....", "#....", "#####"),
    "D": ("####.", "#...#", "#...#", "#...#", "#...#", "#...#", "####."),
}
_GLYPH_MASKS = {c: np.array([[ch == "#" for ch in row] for row in g]) for c, g in _GLYPHS.items()}


class _Panel:
    """One axes box: its data limits, its pixel box and the interior that
    its artists are clipped to (matplotlib clips them to the axes)."""

    def __init__(self, box, xlim, ylim, height: int, scale: float):
        x0, y0, w, h = (v * scale for v in box)
        self.x0, self.w, self.xlim, self.ylim = x0, w, xlim, ylim
        self.top, self.h = height - (y0 + h), h            # image rows grow down
        # matplotlib snaps the frame's 0.8-pt lines to the nearest pixel
        self.cols = (int(round(x0)), int(round(x0 + w)))
        self.rows = (int(round(self.top)), int(round(self.top + h)))
        self.clip = (self.rows[0] + 1, self.rows[1], self.cols[0] + 1, self.cols[1])

    def px(self, x, y):
        """Data coordinates -> image coordinates (u right, v down)."""
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        u = self.x0 + (np.asarray(x, np.float64) - x0) / (x1 - x0) * self.w
        v = self.top + (y1 - np.asarray(y, np.float64)) / (y1 - y0) * self.h
        return u, v

    def marker(self, x, y):
        """A marker's centre in image coordinates: Agg snaps a marker to
        the centre of the pixel nearest its point."""
        u, v = self.px(x, y)
        return np.round(u) + 0.5, np.round(v) + 0.5

    def sx(self, d: float) -> float:
        """A data length along x in pixels."""
        return d / (self.xlim[1] - self.xlim[0]) * self.w


@functools.lru_cache(maxsize=8)
def _layout(arena_size: float, max_height: float, dpi: int):
    """(width, height, top-down panel, side panel, the static background as
    palette indices: white, both frames and the arena circle; read-only)."""
    scale = dpi / 72.0
    width, height = (int(round(v * dpi)) for v in _FIG_INCHES)
    lim = arena_size * _LIM_SCALE
    top = _Panel(_BOX_TOP, (-lim, lim), (-lim, lim), height, scale)
    side = _Panel(_BOX_SIDE, (-lim, lim), (_SIDE_Y[0], _SIDE_Y[1] * max_height), height, scale)
    img = np.full((height, width), _IDX["white"], np.uint8)
    for p in (top, side):
        (r0, r1), (c0, c1) = p.rows, p.cols
        img[r0, c0:c1 + 1] = img[r1, c0:c1 + 1] = _IDX["black"]
        img[r0:r1 + 1, c0] = img[r0:r1 + 1, c1] = _IDX["black"]
    u, v = top.px(0.0, 0.0)
    _ring(img, top.clip, u, v, top.sx(arena_size), _ARENA_LW * scale, _IDX["arena"])
    img.setflags(write=False)
    return width, height, top, side, img


# ------------------------------------------------------------------ primitives
def _window(clip, u, v, reach):
    """The clipped pixel window [r0, r1) x [c0, c1) around (u, v) and its
    pixel centres, or None where it is empty."""
    r0, r1 = max(clip[0], int(math.floor(v - reach))), min(clip[1], int(math.ceil(v + reach)) + 1)
    c0, c1 = max(clip[2], int(math.floor(u - reach))), min(clip[3], int(math.ceil(u + reach)) + 1)
    if r0 >= r1 or c0 >= c1:
        return None
    return r0, r1, c0, c1, np.arange(r0, r1)[:, None] + 0.5, np.arange(c0, c1)[None, :] + 0.5


def _paint(img, win, mask, color) -> None:
    r0, r1, c0, c1 = win[:4]
    img[r0:r1, c0:c1][mask] = color


def _disc(img, clip, u, v, radius, color) -> None:
    win = _window(clip, u, v, radius)
    if win is not None:
        _paint(img, win, (win[4] - v) ** 2 + (win[5] - u) ** 2 <= radius * radius, color)


def _ring(img, clip, u, v, radius, lw, color) -> None:
    half = max(lw / 2.0, 0.5)  # at least one pixel wide, without gaps
    win = _window(clip, u, v, radius + half)
    if win is not None:
        d = np.sqrt((win[4] - v) ** 2 + (win[5] - u) ** 2)
        _paint(img, win, np.abs(d - radius) <= half, color)


def _star(img, clip, u, v, ms, mew, color) -> None:
    """matplotlib's "*" marker: a five-pointed star of outer radius ms / 2
    pointing up, grown by half its outline's width."""
    outer = ms / 2.0 + mew / 2.0
    k = np.arange(10)
    rad = np.where(k % 2 == 0, outer, outer * _STAR_INNER)
    ang = np.pi / 2 + k * np.pi / 5
    pu, pv = u + rad * np.cos(ang), v - rad * np.sin(ang)
    win = _window(clip, u, v, outer)
    if win is None:
        return
    yy, xx = win[4], win[5]
    inside = np.zeros(np.broadcast(yy, xx).shape, bool)
    for a in range(10):  # even-odd rule over the polygon's ten edges
        b = (a + 1) % 10
        crosses = (pv[a] > yy) != (pv[b] > yy)
        at = (pu[b] - pu[a]) * (yy - pv[a]) / np.where(pv[b] == pv[a], 1.0, pv[b] - pv[a]) + pu[a]
        inside ^= crosses & (xx < at)
    _paint(img, win, inside, color)


def _polyline(img, clip, us, vs, color, dash=None) -> None:
    """A polyline through image points (us, vs), one pixel wide: the
    pixels that points sampled at most half a pixel apart fall in; `dash`
    (on, off) in pixels keeps the samples whose arc length falls on."""
    us, vs = np.atleast_1d(us).astype(np.float64), np.atleast_1d(vs).astype(np.float64)
    if len(us) == 1:
        su, sv, arc = us, vs, np.zeros(1)
    else:
        du, dv = np.diff(us), np.diff(vs)
        seg = np.hypot(du, dv)
        n = np.maximum(1, np.ceil(seg / 0.5).astype(np.int64))    # samples a segment
        which = np.repeat(np.arange(len(seg)), n)
        t = (np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(n, n)
        su = np.append(us[which] + t * du[which], us[-1])
        sv = np.append(vs[which] + t * dv[which], vs[-1])
        arc = np.append(np.concatenate(([0.0], np.cumsum(seg)))[which] + t * seg[which],
                        seg.sum())
    if dash is not None:
        keep = np.mod(arc, dash[0] + dash[1]) < dash[0]
        su, sv = su[keep], sv[keep]
    rows, cols = np.floor(sv).astype(np.int64), np.floor(su).astype(np.int64)
    ok = (rows >= clip[0]) & (rows < clip[1]) & (cols >= clip[2]) & (cols < clip[3])
    img[rows[ok], cols[ok]] = color


def _rect(img, clip, ua, va, ub, vb, color) -> None:
    """The pixels whose centres lie in the box between image points a, b."""
    r0 = max(clip[0], int(math.ceil(min(va, vb) - 0.5)))
    r1 = min(clip[1], int(math.floor(max(va, vb) - 0.5)) + 1)
    c0 = max(clip[2], int(math.ceil(min(ua, ub) - 0.5)))
    c1 = min(clip[3], int(math.floor(max(ua, ub) - 0.5)) + 1)
    if r0 < r1 and c0 < c1:
        img[r0:r1, c0:c1] = color


def _text(img, text: str, u_centre: float, baseline: int, scale: int) -> None:
    """`text` in the bitmap font, black, centred on column `u_centre`,
    its bottom row just above image row `baseline`."""
    glyphs = [np.kron(_GLYPH_MASKS.get(c, _GLYPH_MASKS[" "]), np.ones((scale, scale), bool))
              for c in text]
    if not glyphs:
        return
    gap = np.zeros((7 * scale, scale), bool)
    mask = np.concatenate([x for g in glyphs for x in (g, gap)][:-1], axis=1)
    r0, c0 = baseline - mask.shape[0], int(round(u_centre - mask.shape[1] / 2.0))
    rows, cols = np.nonzero(mask)
    rows, cols = rows + r0, cols + c0
    ok = (rows >= 0) & (rows < img.shape[0]) & (cols >= 0) & (cols < img.shape[1])
    img[rows[ok], cols[ok]] = _IDX["black"]


# ------------------------------------------------------------------ frames
def render_index_frame(
    drone_pos, target_pos, cylinders, arena_size: float = 0.9, max_height: float = 1.2,
    cylinder_size: float = 0.1, catch_radius: float = 0.3, captured: bool = False,
    predicted=None, drone_trail=None, target_trail=None, title: str = "", dpi: int = 72,
) -> np.ndarray:
    """`render_frame`'s frame as palette indices, uint8 [H, W]."""
    title = title or ("CAPTURED" if captured else "")
    _, _, top, side, background = _layout(float(arena_size), float(max_height), int(dpi))
    img = background.copy()
    s = dpi / 72.0
    drone_pos = np.asarray(drone_pos, np.float64)
    target_pos = np.asarray(target_pos, np.float64).reshape(3)
    cylinders = np.asarray(cylinders, np.float64)
    active = cylinders[cylinders[:, 2] > 0.0]
    n = drone_pos.shape[0]
    clip = top.clip

    # --- top-down panel, in JAX's z-order: the arena circle (background),
    # cylinders, trails; catch circles; drones; the target; the waypoints
    for cx, cy, _ in active:
        _disc(img, clip, *top.px(cx, cy), top.sx(cylinder_size), _IDX["cylinder"])
    if target_trail is not None and len(target_trail):
        tt = np.asarray(target_trail, np.float64).reshape(-1, 3)
        _polyline(img, clip, *top.px(tt[:, 0], tt[:, 1]), _IDX["target_trail"])
    if drone_trail is not None and len(drone_trail):
        dt = np.asarray(drone_trail, np.float64)
        for i in range(n):
            _polyline(img, clip, *top.px(dt[:, i, 0], dt[:, i, 1]),
                      _IDX[f"trail{i % len(_DRONE_COLORS)}"])
    catch = _IDX["catch_captured" if captured else "catch"]
    for i in range(n):
        _ring(img, clip, *top.px(drone_pos[i, 0], drone_pos[i, 1]), top.sx(catch_radius),
              _CATCH_LW * s, catch)
    for i in range(n):
        _disc(img, clip, *top.marker(drone_pos[i, 0], drone_pos[i, 1]), (_DOT_MS + _MEW) * s / 2,
              _IDX[f"drone{i % len(_DRONE_COLORS)}"])
    _star(img, clip, *top.marker(target_pos[0], target_pos[1]), _STAR_MS * s, _MEW * s,
          _IDX["red"])
    if predicted is not None and len(predicted):
        pred = np.asarray(predicted, np.float64)
        pu, pv = top.px(pred[:, 0], pred[:, 1])
        lw = _PRED_LW * s
        _polyline(img, clip, pu, pv, _IDX["orange"], (_DOTTED[0] * lw, _DOTTED[1] * lw))
        h = _X_MS * s / 2
        for u, v in zip(*top.marker(pred[:, 0], pred[:, 1])):
            _polyline(img, clip, [u - h, u + h], [v - h, v + h], _IDX["orange"])
            _polyline(img, clip, [u - h, u + h], [v + h, v - h], _IDX["orange"])
    _text(img, title, top.x0 + top.w / 2, top.rows[0] - int(round(_TITLE_PAD * s)),
          max(1, int(round(s))))

    # --- side elevation: the cylinders' columns, the ground and the dashed
    # ceiling, the target, the drones
    clip = side.clip
    for cx, _, _ in active:
        ua, va = side.px(cx - cylinder_size, 0.0)
        ub, vb = side.px(cx + cylinder_size, max_height)
        _rect(img, clip, ua, va, ub, vb, _IDX["column"])
    lw = _HLINE_LW * s
    for y, dash in ((0.0, None), (max_height, (_DASHED[0] * lw, _DASHED[1] * lw))):
        _polyline(img, clip, *side.px(np.array(side.xlim), np.array([y, y])), _IDX["arena"],
                  dash)
    _star(img, clip, *side.marker(target_pos[0], target_pos[2]), _SIDE_STAR_MS * s, _MEW * s,
          _IDX["red"])
    for i in range(n):
        _disc(img, clip, *side.marker(drone_pos[i, 0], drone_pos[i, 2]),
              (_SIDE_DOT_MS + _MEW) * s / 2, _IDX[f"drone{i % len(_DRONE_COLORS)}"])
    _text(img, "side", side.x0 + side.w / 2, side.rows[0] - int(round(_TITLE_PAD * s)),
          max(1, int(round(s))))
    return img


def render_frame(
    drone_pos: np.ndarray,          # [n, 3]
    target_pos: np.ndarray,         # [3]
    cylinders: np.ndarray,          # [C, 3] (inactive parked at z < 0)
    arena_size: float = 0.9,
    max_height: float = 1.2,
    cylinder_size: float = 0.1,
    catch_radius: float = 0.3,
    captured: bool = False,
    predicted: Optional[np.ndarray] = None,   # [K, 3] TP-net waypoints
    drone_trail: Optional[np.ndarray] = None,  # [T, n, 3]
    target_trail: Optional[np.ndarray] = None,  # [T, 3]
    title: str = "",
    dpi: int = 72,
) -> np.ndarray:
    """One top-down + side-elevation frame -> uint8 [H, W, 3] (JAX's
    `render_frame`): the arena circle, the active cylinders, the trails,
    each pursuer with its catch circle (red when `captured`), the evader
    and the TP net's predicted waypoints; `title` above the top-down panel
    (JAX writes "CAPTURED" where the title is empty and `captured`)."""
    idx = render_index_frame(drone_pos, target_pos, cylinders, arena_size, max_height,
                             cylinder_size, catch_radius, captured, predicted, drone_trail,
                             target_trail, title, dpi)
    return PALETTE[idx]


def index_trajectory(drone_pos, target_pos, cylinders, captured=None, predicted=None,
                     every: int = 2, trail: int = 120, **kwargs):
    """`render_trajectory`'s frames as palette indices, one at a time."""
    drone_pos = np.asarray(drone_pos)
    target_pos = np.asarray(target_pos).reshape(len(drone_pos), 3)
    cylinders = np.asarray(cylinders)
    for t in range(0, len(drone_pos), every):
        lo = max(0, t - trail)
        yield render_index_frame(
            drone_pos[t], target_pos[t], cylinders[t] if cylinders.ndim == 3 else cylinders,
            captured=bool(captured[t]) if captured is not None else False,
            predicted=predicted[t] if predicted is not None else None,
            drone_trail=drone_pos[lo:t + 1], target_trail=target_pos[lo:t + 1],
            title=f"t={t}", **kwargs)


def render_trajectory(
    drone_pos: np.ndarray,           # [T, n, 3]
    target_pos: np.ndarray,          # [T, 3] (or [T, 1, 3])
    cylinders: np.ndarray,           # [C, 3] or [T, C, 3]
    captured: Optional[np.ndarray] = None,   # [T] bool
    predicted: Optional[np.ndarray] = None,  # [T, K, 3]
    every: int = 2,
    trail: int = 120,
    **kwargs,
) -> List[np.ndarray]:
    """Every `every`-th step of one episode, titled "t=<step>", each with
    the trails of steps max(0, t - trail) .. t (the reference records
    every 2nd frame: scripts/eval.py:209 `Every(record_frame, 2)`)."""
    return [PALETTE[f] for f in index_trajectory(drone_pos, target_pos, cylinders, captured,
                                                 predicted, every, trail, **kwargs)]


# ------------------------------------------------------------------ GIF89a
def to_indices(frame: np.ndarray) -> np.ndarray:
    """An RGB frame [H, W, 3] as palette indices [H, W]: exact where the
    colour is in the palette, else the nearest palette colour (squared RGB
    distance; JAX's PIL quantises such frames too)."""
    def packed(rgb):  # [..., 3] -> 0xRRGGBB
        rgb = np.asarray(rgb, np.int32)
        return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]

    key, pal = packed(frame), packed(PALETTE)
    order = np.argsort(pal)
    pos = np.clip(np.searchsorted(pal[order], key), 0, len(pal) - 1)
    idx = order[pos]
    foreign = pal[idx] != key
    if foreign.any():
        colours, inverse = np.unique(key[foreign], return_inverse=True)
        rgb = np.stack([(colours >> 16) & 255, (colours >> 8) & 255, colours & 255], -1)
        d = ((rgb[:, None, :] - PALETTE[None].astype(np.int32)) ** 2).sum(-1)
        idx[foreign] = np.argmin(d, axis=1)[inverse.reshape(-1)]
    return idx.astype(np.uint8)


_MIN_CODE_SIZE = 8
_CLEAR, _END = 1 << _MIN_CODE_SIZE, (1 << _MIN_CODE_SIZE) + 1
_MAX_CODES = 4096                     # 12-bit codes


def _lzw_codes(data: bytes):
    """GIF's LZW over `data` (bytes of palette indices): (codes, widths).

    A clear code first; greedy longest match; the code width grows from 9
    bits as the table does, to 12; when the table is full a clear code
    restarts it.  The table holds each multi-byte string as bytes, and
    every prefix of an entry is an entry (an entry is an older one plus a
    byte), so the longest match at a position is found by galloping over
    lengths 2, 4, 8, ... and bisecting: a few hashed slices a code."""
    codes, widths = [_CLEAR], [_MIN_CODE_SIZE + 1]
    table: Dict[bytes, int] = {}
    next_code, width = _END + 1, _MIN_CODE_SIZE + 1
    n, i = len(data), 0
    get = table.get
    while i < n:
        # the longest match data[i:i + good]: single bytes are literals
        good, code = 1, data[i]
        step = 2
        while i + step <= n:
            c = get(data[i:i + step])
            if c is None:
                break
            good, code = step, c
            step *= 2
        bad = min(step, n - i + 1)
        while bad - good > 1:
            mid = (good + bad) // 2
            c = get(data[i:i + mid])
            if c is None:
                bad = mid
            else:
                good, code = mid, c
        codes.append(code)
        widths.append(width)
        if i + good < n:
            if next_code == _MAX_CODES:
                codes.append(_CLEAR)
                widths.append(width)
                table.clear()
                next_code, width = _END + 1, _MIN_CODE_SIZE + 1
            else:
                table[data[i:i + good + 1]] = next_code
                next_code += 1
                if next_code > 1 << width and width < 12:
                    width += 1
        i += good
    # the decoder adds an entry after the last code too (unless it follows
    # a clear): the end code takes the width that entry gives
    codes.append(_END)
    widths.append(width + 1 if next_code >= 1 << width and width < 12 and len(codes) > 2
                  and codes[-2] != _CLEAR else width)
    return codes, widths


def _pack(codes: Sequence[int], widths: Sequence[int]) -> bytes:
    """Codes of the given widths packed least significant bit first."""
    codes = np.asarray(codes, np.int64)
    widths = np.asarray(widths, np.int64)
    bits = (codes[:, None] >> np.arange(12)[None, :]) & 1
    bits = bits[np.arange(12)[None, :] < widths[:, None]].astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for k in range(0, len(data), 255):
        chunk = data[k:k + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode_gif(frames: Sequence[np.ndarray], fps: float = 25.0) -> bytes:
    """GIF89a bytes of palette-index frames [H, W] (`save_gif`'s file).
    After the first, each frame is stored as the bounding box of the
    pixels that differ from the frame before, on top of it (disposal 1,
    "do not dispose"); a frame equal to the one before stores one pixel."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("save_gif: no frames")
    h, w = frames[0].shape
    table = np.zeros((1 << _GIF_TABLE_BITS, 3), np.uint8)
    table[:len(PALETTE)] = PALETTE
    delay = int(max(1, int(1000.0 / fps)) / 10)            # centiseconds, as PIL writes
    out = bytearray(b"GIF89a")
    out += np.array([w, h], "<u2").tobytes()
    out += bytes([0x80 | (7 << 4) | (_GIF_TABLE_BITS - 1), 0, 0])   # global table, 8-bit
    out += table.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"            # loop forever
    prev = None
    for f in frames:
        if f.shape != (h, w):
            raise ValueError(f"save_gif: frame of shape {f.shape} after {(h, w)}")
        if prev is None:
            r0, r1, c0, c1 = 0, h, 0, w
        else:
            diff = f != prev
            rows, cols = np.flatnonzero(diff.any(1)), np.flatnonzero(diff.any(0))
            if len(rows):
                r0, r1, c0, c1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
            else:
                r0, r1, c0, c1 = 0, 1, 0, 1
        out += b"\x21\xf9\x04\x04" + np.array([delay], "<u2").tobytes() + b"\x00\x00"
        out += b"\x2c" + np.array([c0, r0, c1 - c0, r1 - r0], "<u2").tobytes() + b"\x00"
        out.append(_MIN_CODE_SIZE)
        out += _sub_blocks(_pack(*_lzw_codes(f[r0:r1, c0:c1].tobytes())))
        prev = f
    out.append(0x3B)
    return bytes(out)


def save_gif(frames: Sequence[np.ndarray], path: str, fps: float = 25.0) -> str:
    """Write RGB frames [H, W, 3] as an animated GIF that loops (the
    eval-video sink; the reference uploads wandb.Video at fps = 0.5/dt,
    scripts/eval.py:245-251): a frame every max(1, int(1000 / fps)) ms,
    stored in centiseconds (40 ms -> 4 at 25 fps), over `PALETTE`."""
    with open(path, "wb") as f:
        f.write(encode_gif([to_indices(fr) for fr in frames], fps))
    return path


def episode_video(
    rollout_info: Dict[str, np.ndarray],
    env_cfg,
    path: str,
    env_index: int = 0,
    fps: float = 25.0,
    every: int = 2,
) -> str:
    """Per-step evaluation info as stacked host arrays -> a GIF of one
    arena (`render_trajectory`'s frames through `save_gif`, kept as
    palette indices between the two).  Expects keys 'drone_pos'
    [T,E,n,3], 'target_pos' [T,E,1,3], 'cylinders' [T,E,C,3]; optional
    'capture' [T,E,1] and 'tp_pred' [T,E,K,3]."""
    e = env_index
    frames = index_trajectory(
        rollout_info["drone_pos"][:, e],
        rollout_info["target_pos"][:, e, 0],
        rollout_info["cylinders"][:, e],
        captured=rollout_info["capture"][:, e, 0] if "capture" in rollout_info else None,
        predicted=rollout_info["tp_pred"][:, e] if "tp_pred" in rollout_info else None,
        every=every,
        arena_size=env_cfg.arena_size,
        max_height=env_cfg.max_height,
        cylinder_size=env_cfg.cylinder_size,
        catch_radius=env_cfg.catch_radius,
    )
    with open(path, "wb") as f:
        f.write(encode_gif(list(frames), fps))
    return path
