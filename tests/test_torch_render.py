"""The port's renderer and GIF writer (`mupe_tpu_torch/utils/render.py`)
on the CPU: against the JAX package's matplotlib frames, by its own
geometry, and its GIF89a decoded back.

JAX's frames antialias (a few hundred colours a frame), the port's do not
(every pixel a palette colour), so the frames cannot match pixel for
pixel.  What must match is where things are: drones 1 and 2 (#2ca02c,
#9467bd) are colours nothing else in a frame has, so the centroid of their
exact-colour pixels in each panel is held within CENTROID_PX of
matplotlib's (measured on these layouts: 0 px; Agg snaps a marker to
the centre of its nearest pixel and so does the port), and so is each
active cylinder's grey-0.65 disc (measured: at most 0.21 px); a
parked cylinder (z < 0) is drawn by neither; both frames' panel frames lie
on the same pixel rows and columns.

The GIF is decoded twice, by PIL (where it imports) and by `decode_gif`
below, and must give back the frames exactly.
"""
import io
import math
import struct
from pathlib import Path

import numpy as np
import pytest

from mupe_tpu.utils import render as jrender
from mupe_tpu_torch.utils import render

CENTROID_PX = 2.0
H, W = 324, 576
TOP_BOX, SIDE_BOX = (28, 313, 53, 339), (28, 313, 400, 565)   # panel interiors (rows, cols)


# ------------------------------------------------------------------ a GIF decoder
def lzw_decode(data: bytes, min_size: int):
    """GIF's LZW: (the indices, the number of clear codes read)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, table, width, prev, clears = bytearray(), [], min_size + 1, None, 0
    acc = nbits = pos = 0
    while True:
        while nbits < width:
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            width, prev, clears = min_size + 1, None, clears + 1
            continue
        if code == end:
            return bytes(out), clears
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            assert code <= len(table), "a code past the table"
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == 1 << width and width < 12:
                    width += 1
        out += entry
        prev = entry


def decode_gif(data: bytes) -> dict:
    """The GIF89a's composited RGB frames, delays (cs), disposals, loop
    count, colour table, image rectangles and clear codes."""
    assert data[:6] == b"GIF89a"
    w, h, packed = struct.unpack("<HHB", data[6:11])
    assert packed & 0x80, "no global colour table"
    size = 2 << (packed & 7)
    table = np.frombuffer(data[13:13 + 3 * size], np.uint8).reshape(size, 3)
    pos = 13 + 3 * size
    canvas = np.full((h, w), data[11], np.uint8)
    res = dict(frames=[], delays=[], disposal=[], loop=None, table=table, rects=[], clears=[],
               size=(w, h))
    while True:
        kind = data[pos]
        if kind == 0x3B:
            return res
        if kind == 0x21:
            label, pos, blocks = data[pos + 1], pos + 2, []
            while data[pos]:
                blocks.append(data[pos + 1:pos + 1 + data[pos]])
                pos += 1 + data[pos]
            pos += 1
            if label == 0xF9:
                res["delays"].append(struct.unpack("<H", blocks[0][1:3])[0])
                res["disposal"].append((blocks[0][0] >> 2) & 7)
            elif label == 0xFF and blocks[0] == b"NETSCAPE2.0":
                res["loop"] = struct.unpack("<H", blocks[1][1:3])[0]
        else:
            assert kind == 0x2C
            x, y, fw, fh, flags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            assert flags == 0, "local table or interlace"
            min_size, pos, lzw = data[pos + 10], pos + 11, bytearray()
            while data[pos]:
                lzw += data[pos + 1:pos + 1 + data[pos]]
                pos += 1 + data[pos]
            pos += 1
            pix, clears = lzw_decode(bytes(lzw), min_size)
            assert len(pix) == fw * fh
            canvas[y:y + fh, x:x + fw] = np.frombuffer(pix, np.uint8).reshape(fh, fw)
            res["frames"].append(table[canvas])
            res["rects"].append((x, y, fw, fh))
            res["clears"].append(clears)


def pil_frames(path):
    Image = pytest.importorskip("PIL.Image")
    with Image.open(path) as im:
        out = []
        for k in range(im.n_frames):
            im.seek(k)
            out.append(np.asarray(im.convert("RGB")))
        return out, im.info


# ------------------------------------------------------------------ layouts
def layout(seed: int):
    """Three pursuers, the evader and two active cylinders apart from each
    other, and a parked cylinder at (0.5, -0.5)."""
    rng = np.random.default_rng(seed)
    while True:
        xy = rng.uniform(-0.75, 0.75, (6, 2))
        if min(np.linalg.norm(xy[i] - xy[j]) for i in range(6) for j in range(i)) > 0.3 \
                and np.linalg.norm(xy - [0.5, -0.5], axis=1).min() > 0.3:
            break
    drones = np.concatenate([xy[:3], rng.uniform(0.15, 1.3, (3, 1))], 1)
    target = np.append(xy[3], 0.6)
    cyl = np.array([[*xy[4], 0.6], [*xy[5], 0.6], [0.5, -0.5, -1.0]])
    return drones, target, cyl


def centroid(img, colour, box, near=None, reach=None):
    r0, r1, c0, c1 = box
    mask = (img[r0:r1, c0:c1] == colour).all(-1)
    rows, cols = np.nonzero(mask)
    rows, cols = rows + r0, cols + c0
    if near is not None:
        keep = np.hypot(rows + 0.5 - near[1], cols + 0.5 - near[0]) <= reach
        rows, cols = rows[keep], cols[keep]
    return (np.array([rows.mean(), cols.mean()]) if len(rows) else None), len(rows)


@pytest.fixture(scope="module")
def jax_frames():
    """(layout, JAX's frame, the port's frame) at four seeded layouts."""
    out = []
    for seed in range(4):
        d, t, c = layout(seed)
        kw = dict(title="t=0")
        out.append(((d, t, c), jrender.render_frame(d, t, c, **kw),
                    render.render_frame(d, t, c, **kw)))
    return out


def test_drone_centroids_match_jax(jax_frames):
    worst = 0.0
    for _, want, got in jax_frames:
        for i in (1, 2):
            colour = render.PALETTE[render._IDX[f"drone{i}"]]
            for box in (TOP_BOX, SIDE_BOX):
                a, na = centroid(got, colour, box)
                b, nb = centroid(want, colour, box)
                assert na > 20 and nb > 10, (i, box, na, nb)
                worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= CENTROID_PX, worst


def test_cylinders_match_jax_and_parked_ones_are_absent(jax_frames):
    grey = render.PALETTE[render._IDX["cylinder"]]
    _, _, top, _, _ = render._layout(0.9, 1.2, 72)
    worst = 0.0
    for (_, _, cyl), want, got in jax_frames:
        for cx, cy, cz in cyl:
            u, v = top.px(cx, cy)
            a, na = centroid(got, grey, TOP_BOX, (u, v), top.sx(0.1) + 2)
            b, nb = centroid(want, grey, TOP_BOX, (u, v), top.sx(0.1) + 2)
            if cz < 0:
                assert na == 0 and nb == 0
                continue
            assert na > 300 and nb > 300, (na, nb)
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= CENTROID_PX, worst


def test_panel_frames_on_jax_pixels(jax_frames):
    _, want, got = jax_frames[0]
    for frame in (want, got):
        dark = frame.sum(-1) < 200                       # black, and Agg's 0.8-pt grey 51
        assert set(np.flatnonzero(dark[150])) >= {52, 339, 399, 565}
        assert set(np.flatnonzero(dark[:, 200])) >= {27, 313}
        assert set(np.flatnonzero(dark[:, 480])) >= {27, 313}
    black = (got == 0).all(-1)
    assert black[27:314, [52, 339, 399, 565]].all() and black[[27, 313], 52:340].all()


def test_layout_constants_are_matplotlibs():
    """The constants in render.py, recomputed from JAX's figure."""
    plt = pytest.importorskip("matplotlib.pyplot")
    fig, (ax, axz) = plt.subplots(1, 2, figsize=render._FIG_INCHES, dpi=72,
                                  width_ratios=[1.0, 0.45])
    lim = 0.9 * 1.15
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    for a, title in ((ax, "t=798"), (axz, "side")):
        a.set_title(title)
        a.set_xticks(())
    ax.set_yticks(())
    axz.set_xlim(-lim, lim)
    axz.set_ylim(-0.05, 1.2 * 1.2)
    fig.tight_layout()
    fig.canvas.draw()
    for a, box in ((ax, render._BOX_TOP), (axz, render._BOX_SIDE)):
        np.testing.assert_allclose(a.get_window_extent().bounds, box, atol=1e-5)
    assert fig.canvas.get_width_height() == (W, H)
    plt.close(fig)


# ------------------------------------------------------------------ by its own geometry
def test_drones_catch_circles_and_waypoints_where_the_map_puts_them():
    drones, target, cyl = layout(7)
    _, _, top, side, _ = render._layout(0.9, 1.2, 72)
    pred = np.zeros((5, 3))  # HideAndSeek's tp_pred without the TP net
    for captured in (False, True):
        f = render.render_index_frame(drones, target, cyl, captured=captured, predicted=pred,
                                      title="t=4")
        for i, (x, y, z) in enumerate(drones):
            for panel, (a, b) in ((top, (x, y)), (side, (x, z))):
                u, v = panel.marker(a, b)
                assert f[int(v), int(u)] == render._IDX[f"drone{i}"], (i, panel)
            # the catch circle, 0.3 m from the drone toward the arena's centre
            u, v = top.px(x, y - 0.3 * np.sign(y))
            ring = f[int(v) - 1:int(v) + 2, int(u)]
            assert render._IDX["catch_captured" if captured else "catch"] in ring
        u, v = top.marker(0.0, 0.0)  # the waypoints' x at the origin
        assert f[int(v), int(u)] == render._IDX["orange"]
        assert f[int(v) - 2, int(u) - 2] == render._IDX["orange"]


@pytest.mark.parametrize("steps,every", [(9, 2), (8, 2), (7, 3)])
def test_trajectory_frames(steps, every):
    rng = np.random.default_rng(steps)
    dp = rng.uniform(-0.8, 0.8, (steps, 3, 3))
    tp = rng.uniform(-0.8, 0.8, (steps, 1, 3))           # [T, 1, 3] as episode_video's
    cyl = rng.uniform(-0.8, 0.8, (steps, 4, 3))          # [T, C, 3]: some parked
    frames = render.render_trajectory(dp, tp, cyl, captured=rng.uniform(size=steps) > 0.5,
                                      predicted=rng.uniform(-1, 1, (steps, 5, 3)), every=every)
    assert len(frames) == math.ceil(steps / every)
    pal = {tuple(c) for c in render.PALETTE}
    for f in frames:
        assert f.shape == (H, W, 3) and f.dtype == np.uint8
        assert {tuple(c) for c in np.unique(f.reshape(-1, 3), axis=0)} <= pal
    # [C, 3] cylinders give the frames of a [T, C, 3] constant
    a = render.render_trajectory(dp, tp, cyl[0], every=every)
    b = render.render_trajectory(dp, tp, np.broadcast_to(cyl[0], cyl.shape), every=every)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_trails_start_at_t_minus_trail():
    """A trail runs over steps max(0, t - trail) .. t: a drone that sat at
    a corner before step t - trail leaves no trail there."""
    t_len, trail = 12, 5
    dp = np.tile(np.array([[0.0, 0.0, 0.5]]), (t_len, 1, 1))
    dp[:3, 0] = [-0.9, 0.9, 0.5]                          # steps 0-2 in a corner
    tp = np.tile([0.5, 0.5, 0.5], (t_len, 1))
    frames = render.render_trajectory(dp, tp, np.zeros((0, 3)), every=1, trail=trail)
    _, _, top, _, _ = render._layout(0.9, 1.2, 72)
    u, v = top.px(-0.6, 0.6)  # on the path from the corner to the centre
    trail0 = render.PALETTE[render._IDX["trail0"]]
    seen = [bool((f[int(v) - 3:int(v) + 4, int(u) - 3:int(u) + 4] == trail0).all(-1).any())
            for f in frames]
    assert seen[3:8] == [True] * 5 and seen[8:] == [False] * 4  # t - 5 <= 2 up to t = 7


def test_captured_title_and_unknown_characters():
    drones, target, cyl = layout(1)
    f = render.render_index_frame(drones, target, cyl, captured=True)
    assert (f[10:21, 150:240] == render._IDX["black"]).sum() > 30   # "CAPTURED"
    g = render.render_index_frame(drones, target, cyl, title="t=1?")  # "?" is blank
    h = render.render_index_frame(drones, target, cyl, title="t=1 ")
    assert np.array_equal(g, h)


# ------------------------------------------------------------------ the GIF
def _frames(n):
    """`n` frames of three pursuers circling an evader that sways."""
    t = np.linspace(0.0, 1.0, 2 * n)[:, None]
    phase = 3.0 * t + np.array([0.0, 2.0, 4.0])                       # [2n, 3]
    dp = np.stack([0.7 * np.cos(phase), 0.7 * np.sin(phase),
                   0.5 + 0.2 * np.arange(3) + 0.0 * t], -1)            # [2n, 3, 3]
    tp = np.concatenate([0.3 * np.sin(5.0 * t), 0.0 * t, 0.6 + 0.0 * t], -1)
    cyl = np.array([[0.2, 0.3, 0.6], [-0.4, -0.3, 0.6], [0.5, 0.0, -1.0]])
    return render.render_trajectory(dp, tp, cyl, captured=np.arange(2 * n) > n,
                                    predicted=np.zeros((2 * n, 5, 3)))


def test_gif_decodes_back_to_the_frames(tmp_path):
    frames = _frames(12)
    path = render.save_gif(frames, str(tmp_path / "a.gif"))
    data = Path(path).read_bytes()
    got = decode_gif(data)
    assert len(got["frames"]) == len(frames) == 12
    assert all(np.array_equal(a, b) for a, b in zip(got["frames"], frames))
    assert got["delays"] == [4] * 12 and got["loop"] == 0 and got["size"] == (W, H)
    assert len(got["table"]) == 32 and got["disposal"] == [1] * 12
    assert got["rects"][0] == (0, 0, W, H) and all(r[2] * r[3] < W * H for r in got["rects"][1:])
    pil, info = pil_frames(path)
    assert len(pil) == 12 and all(np.array_equal(a, b) for a, b in zip(pil, frames))
    assert info["duration"] == 40 and info["loop"] == 0


def test_gif_delay_follows_fps(tmp_path):
    frames = _frames(2)
    for fps, cs in ((25.0, 4), (10.0, 10), (0.5, 200), (1000.0, 0)):
        got = decode_gif(render.encode_gif([render.to_indices(f) for f in frames], fps))
        assert got["delays"] == [cs, cs], fps


def test_foreign_colours_take_the_nearest_palette_colour(tmp_path):
    f = np.full((6, 8, 3), 255, np.uint8)
    f[0, 0] = (250, 250, 250)      # near white
    f[1, 1] = (10, 200, 40)        # near #2ca02c
    f[2, 2] = (220, 30, 35)        # near #d62728
    f[3, 3] = (0, 0, 0)            # black, exact
    want = f.copy()
    want[0, 0] = 255
    want[1, 1] = render.PALETTE[render._IDX["drone1"]]
    want[2, 2] = render.PALETTE[render._IDX["red"]]
    got = decode_gif(Path(render.save_gif([f], str(tmp_path / "c.gif"))).read_bytes())
    np.testing.assert_array_equal(got["frames"][0], want)
    pil, _ = pil_frames(tmp_path / "c.gif")
    np.testing.assert_array_equal(pil[0], want)


def test_one_colour_frames_and_repeats(tmp_path):
    white = np.full((H, W, 3), 255, np.uint8)
    path = render.save_gif([white, white, white], str(tmp_path / "w.gif"))
    got = decode_gif(Path(path).read_bytes())
    assert all(np.array_equal(f, white) for f in got["frames"])
    assert got["rects"][1:] == [(0, 0, 1, 1)] * 2
    assert Path(path).stat().st_size < 2000
    pil, _ = pil_frames(path)
    assert len(pil) == 3 and all(np.array_equal(f, white) for f in pil)


def test_a_full_code_table_restarts_with_a_clear_code(tmp_path):
    """Noise fills the 4,096-code table many times a frame."""
    rng = np.random.default_rng(3)
    frames = [render.PALETTE[rng.integers(0, len(render.PALETTE), (H, W))] for _ in range(3)]
    path = render.save_gif(frames, str(tmp_path / "n.gif"))
    got = decode_gif(Path(path).read_bytes())
    assert min(got["clears"]) > 10
    assert all(np.array_equal(a, b) for a, b in zip(got["frames"], frames))
    pil, _ = pil_frames(path)
    assert all(np.array_equal(a, b) for a, b in zip(pil, frames))


def test_lzw_round_trips_at_every_width_edge():
    """Short streams of every length up to 1,200 over a 3-colour alphabet:
    the code width grows at 512, 1,024 and 2,048 entries, and the end code
    takes the width the decoder's last entry gives (hit at some lengths)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 3, 1200).astype(np.uint8).tobytes()
    end_wider = []
    for n in range(1, 1201):
        codes, widths = render._lzw_codes(base[:n])
        if widths[-1] > widths[-2]:
            end_wider.append(n)
        out, _ = lzw_decode(render._pack(codes, widths), 8)
        assert out == base[:n], n
    assert end_wider  # measured: 4 lengths
    Image = pytest.importorskip("PIL.Image")
    for n in end_wider:
        row = np.frombuffer(base[:n], np.uint8).reshape(1, n)
        with Image.open(io.BytesIO(render.encode_gif([row]))) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), render.PALETTE[row])

