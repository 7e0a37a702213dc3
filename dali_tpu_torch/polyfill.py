"""A polygon fill bit-equal to OpenCV's ``cv2.fillPoly(img, [pts], value)``
with its defaults (8-connected lines, ``shift=0``), for COCO's pixelwise
masks; the port has no cv2.

OpenCV fills in two passes, and so does this module. First every edge is
drawn as an 8-connected Bresenham line (``Line`` over a ``LineIterator``
that clips to the image and runs left to right), which covers the pixels of
slanted sides that the interior fill leaves out. Then the edges that are not
horizontal are filled by an active-edge scanline pass over 16.16 fixed-point
x (``FillEdgeCollection``): each row fills the spans between pairs of active
edges, from the left x rounded up to the right x rounded down, edges enter
at their upper end and leave at their lower end, and the active list is
bubble-sorted by x after each row. An edge that crosses the image border
takes its x from its clipped ends (``clipLine``), and its y too unless the
clipped segment is flat. These rules were read off OpenCV 5.0's output:
``tests/test_torch_readers_raw.py`` holds the fill against ``cv2.fillPoly``
over random and COCO-like polygons.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a ``width`` x ``height`` image: the
    segment's ends moved onto the border, and whether any of it lies
    inside."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def draw_line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value):
    """OpenCV's 8-connected ``Line``: the ``LineIterator`` from the left end
    to the right one, after clipping to the image."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # step k moves along the major axis, and along the minor one where the
    # error term before it is negative: err_k = major - 2 minor (k + 1)
    # + 2 major m_k with m_k the minor steps so far, so m_k is the closed form
    # below
    k = np.arange(major + 1, dtype=np.int64)
    m = (2 * minor * k + major - 1) // (2 * major) if major else k
    if vert:
        ys, xs = y1 + sy * k, x1 + m
    else:
        xs, ys = x1 + k, y1 + sy * m
    img[ys, xs] = value


def fill_poly(img: np.ndarray, pts: np.ndarray, value) -> None:
    """``cv2.fillPoly(img, [pts], value)`` on a 2-D image or one with a
    trailing channel of 1: ``pts`` is [n, 2] int32 (x, y), n >= 1."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    plane = img.reshape(img.shape[0], img.shape[1]) if img.ndim == 3 else img
    h, w = plane.shape
    n = len(pts)
    edges = []  # [y0, y1, x, dx]
    x0, y0 = int(pts[n - 1, 0]) << XY_SHIFT, int(pts[n - 1, 1])
    for i in range(n):
        x1, y1 = int(pts[i, 0]) << XY_SHIFT, int(pts[i, 1])
        t0x, t1x = (x0 + (XY_ONE >> 1)) >> XY_SHIFT, (x1 + (XY_ONE >> 1)) >> XY_SHIFT
        draw_line(plane, t0x, y0, t1x, y1, value)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= y0 < h and 0 <= y1 < h):
            # an edge crossing the border runs from its clipped ends: x
            # always, y unless the clipped segment is flat
            _, a_x, a_y, b_x, b_y = clip_line(w, h, t0x, y0, t1x, y1)
            c0x, c1x = a_x << XY_SHIFT, b_x << XY_SHIFT
            if a_y != b_y:
                c0y, c1y = a_y, b_y
        if y0 != y1:
            dx = _tdiv(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append([y0, y1, c0x + (y0 - c0y) * dx, dx])
            else:
                edges.append([y1, y0, c1x + (y1 - c1y) * dx, dx])
        x0, y0 = x1, y1
    _fill_edges(plane, edges, value)


def _fill_edges(img: np.ndarray, edges, value):
    """OpenCV's ``FillEdgeCollection`` for 8-connected lines, in closed
    form. OpenCV walks an active-edge list row by row: edges enter at their
    upper end and leave at their lower end, the list stays sorted by x, each
    consecutive pair bounds a span, and both edges of a pair step x by dx.
    A closed polygon has an even number of edges across every row (edges
    cover ``[y0, y1)``), so every active edge steps once per row and its x
    at row y is ``x + (y - y0) dx`` exactly; the spans of a row are then
    its sorted xs taken in pairs."""
    h, w = img.shape
    if len(edges) < 2:
        return
    e = np.asarray(edges, np.int64)  # [y0, y1, x, dx]
    y0, y1, x, dx = e.T
    ends = x + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x.max(), ends.max()) < 0
            or min(x.min(), ends.min()) >= (w << XY_SHIFT)):
        return
    lo, hi = np.maximum(y0, 0), np.minimum(y1, h)  # rows drawn: 0 <= y < h
    n = np.maximum(hi - lo, 0)
    if not n.any():
        return
    k = np.repeat(np.arange(len(e)), n)
    rows = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n) + lo[k]
    xs = x[k] + (rows - y0[k]) * dx[k]
    order = np.lexsort((xs, rows))
    rows, xs = rows[order].reshape(-1, 2), xs[order].reshape(-1, 2)
    # a span runs from the left x rounded up to the right x rounded down
    xa = (xs[:, 0] + XY_ONE - 1) >> XY_SHIFT
    xb = xs[:, 1] >> XY_SHIFT
    keep = (xa < w) & (xb >= 0)
    xa, xb, r = np.maximum(xa[keep], 0), np.minimum(xb[keep], w - 1), rows[keep, 0]
    for row, a, b in zip(r.tolist(), xa.tolist(), xb.tolist()):
        img[row, a:b + 1] = value
