"""Metric plots as PNG files, in numpy (the card's machine has no
matplotlib).

Each plot is the size of matplotlib's default ``figsize=(10, 8)`` at 100
dpi, 1000 x 800 px, which the JAX package saves: a white canvas, the
axes frame where matplotlib's default subplot puts it (left .125, right
.9, bottom .11, top .88 of the figure) and each curve as a 1 px polyline
in its colour, clipped to the axes.  No text: no title, tick labels or
legend (README, the port's COMPAT notes).
"""

import numpy as np

from ..imageio import write_png

WIDTH, HEIGHT = 1000, 800
# the axes box in pixels: columns left..right, rows top..bottom
LEFT, RIGHT = int(0.125 * WIDTH), int(0.9 * WIDTH)
TOP, BOTTOM = int((1 - 0.88) * HEIGHT), int((1 - 0.11) * HEIGHT)


def bgr(color):
    """"#rrggbb" -> (b, g, r) uint8."""
    r, g, b = (int(color[i:i + 2], 16) for i in (1, 3, 5))
    return np.array([b, g, r], np.uint8)


def step_post(x, y):
    """The vertices of matplotlib's ``step(x, y, where="post")``."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.repeat(x, 2)[1:], np.repeat(y, 2)[:-1]


def _polyline(img, px, py, color):
    """Segments between consecutive pixel vertices, sampled densely
    enough that no pixel along a segment is skipped, clipped to the
    axes box."""
    if px.size == 1:
        px, py = np.r_[px, px], np.r_[py, py]
    n = np.ceil(np.maximum(np.abs(np.diff(px)), np.abs(np.diff(py))))
    n = n.astype(np.int64) + 1
    seg = np.repeat(np.arange(n.size), n)
    t = (np.arange(seg.size) - np.repeat(np.cumsum(n) - n, n)) / np.maximum(
        np.repeat(n - 1, n), 1)
    xs = np.rint(px[seg] + t * (px[seg + 1] - px[seg])).astype(np.int64)
    ys = np.rint(py[seg] + t * (py[seg + 1] - py[seg])).astype(np.int64)
    inside = (xs >= LEFT) & (xs <= RIGHT) & (ys >= TOP) & (ys <= BOTTOM)
    img[ys[inside], xs[inside]] = color


def render(curves, xlim, ylim):
    """uint8 (HEIGHT, WIDTH, 3) BGR canvas: the axes frame and each
    curve (x, y, "#rrggbb") mapped from data limits ``xlim``/``ylim``."""
    img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    for x, y, color in curves:
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        keep = np.isfinite(x) & np.isfinite(y)
        if not keep.any():
            continue
        px = LEFT + (x[keep] - xlim[0]) / (xlim[1] - xlim[0]) * (RIGHT - LEFT)
        py = BOTTOM - (y[keep] - ylim[0]) / (ylim[1] - ylim[0]) * (
            BOTTOM - TOP)
        # far outside the axes only lengthens segments that are clipped
        _polyline(img, np.clip(px, -WIDTH, 2 * WIDTH),
                  np.clip(py, -HEIGHT, 2 * HEIGHT), bgr(color))
    img[TOP, LEFT:RIGHT + 1] = img[BOTTOM, LEFT:RIGHT + 1] = 0
    img[TOP:BOTTOM + 1, LEFT] = img[TOP:BOTTOM + 1, RIGHT] = 0
    return img


def save_plot(path, curves, xlim, ylim):
    """`render` written to ``path`` as PNG."""
    write_png(path, render(curves, xlim, ylim))
