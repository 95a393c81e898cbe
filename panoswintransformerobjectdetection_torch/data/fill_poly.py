"""OpenCV's `fillPoly` on a uint8 bitmap, pixel for pixel, without OpenCV.

The JAX package rasterises each object's polygons with `cv2.fillPoly(mask,
polys, 1)` (8-connected, no sub-pixel shift); the card's machine has no
OpenCV, so the port carries the same algorithm (OpenCV's `drawing.cpp`:
`CollectPolyEdges`, `FillEdgeCollection`, `LineIterator`, `clipLine`).  All
of an object's polygons are filled together, so the spans run between
successive edges of the whole set and a polygon inside another is a hole.
Every edge is also drawn as an 8-connected line, which the fill alone may
miss (edge pixels, polygons of no area).  An edge with an end outside the
image takes its x from the segment clipped to the image (`clip_line`), its
rows from the clipped segment where that has two, and a row's span runs
from the ceiling of its left edge's x to the floor of its right edge's.
Coordinates are 16.16 fixed point in int64, divisions truncate toward zero
and shifts are arithmetic, as in C.  These rules were fixed against
OpenCV 5.0's `cv2.fillPoly` (`tests/test_torch_mask_pipeline.py`); COCO's
own rasteriser (`core/rle.polygon_to_rle`) gives other pixels.
"""

from typing import List, Sequence

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's `clipLine` on a w x h image: (inside, x1, y1, x2, y2), the
    points moved onto the border where the segment crosses it (or left
    partly moved when it misses the image)."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
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


def line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels (ys, xs) of OpenCV's 8-connected `LineIterator` from
    (x1, y1) to (x2, y2), left to right, clipped to a w x h image."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, step_y = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    k = np.arange(dx + 1, dtype=np.int64)
    # the Bresenham error term err_k = dx - 2 dy (k + 1) + 2 dx m_k steps the
    # minor axis whenever it is negative: m_k = ceil((2 k dy - dx) / (2 dx))
    minor = (2 * k * dy + dx - 1) // (2 * dx) if dx else k
    if vert:
        return y1 + step_y * k, x1 + minor
    return y1 + step_y * minor, x1 + k


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray], value: int = 1) -> None:
    """`cv2.fillPoly(img, polys, value)` in place: img (H, W) uint8; polys
    (n, 2) integer (x, y) points each."""
    h, w = img.shape
    edges: List[list] = []                     # [y0, y1, x, dx, next]
    for pts in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
        if not pts:
            continue
        x0, y0 = pts[-1]
        for x1, y1 in pts:
            ys, xs = line_pixels(w, h, x0, y0, x1, y1)
            img[ys, xs] = value
            c0x, c0y, c1x, c1y = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
                _, t0x, t0y, t1x, t1y = clip_line(w, h, x0, y0, x1, y1)
                if t0y != t1y:
                    c0y, c1y = t0y, t1y
                c0x, c1x = t0x << XY_SHIFT, t1x << XY_SHIFT
            if y0 != y1:
                dx = _cdiv(c1x - c0x, c1y - c0y)
                if y0 < y1:
                    edges.append([y0, y1, c0x + (y0 - c0y) * dx, dx, None])
                else:
                    edges.append([y1, y0, c1x + (y1 - c1y) * dx, dx, None])
            x0, y0 = x1, y1
    _fill_edges(img, edges, value)


def _fill_edges(img: np.ndarray, edges: List[list], value: int) -> None:
    """OpenCV's `FillEdgeCollection` (8-connected): a scanline from the
    highest edge down, the active edges kept in a list sorted by x, a span
    drawn between each pair, each edge's x stepped by its slope."""
    h, w = img.shape
    total = len(edges)
    if total < 2:
        return
    y_min, y_max = min(e[0] for e in edges), max(e[1] for e in edges)
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    x_min = min(min(e[2] for e in edges), min(ends))
    x_max = max(-1, max(e[2] for e in edges), max(ends))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    edges.append([1 << 62, 0, 0, 0, None])      # a sentinel that no row reaches
    head = [0, 0, 0, 0, None]                    # the list's head; next = edge 4
    i = 0
    e = edges[0]
    for y in range(e[0], min(y_max, h)):
        draw = False
        prelast, last = head, head[4]
        while last is not None or e[0] == y:
            if last is not None and last[1] == y:
                prelast[4] = last = last[4]     # the edge ends on this row
                continue
            keep_prelast = prelast
            if last is not None and (e[0] > y or last[2] < e[2]):
                prelast, last = last, last[4]
            elif i < total:
                prelast[4] = e                  # the next edge starts on this row
                e[4] = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    lo, hi = sorted((keep_prelast[2], prelast[2]))
                    x1, x2 = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = value
                keep_prelast[2] += keep_prelast[3]
                prelast[2] += prelast[3]
            draw = not draw
        _sort_active(head)


def _sort_active(head: list) -> None:
    """OpenCV's bubble sort of the active edges by x, swaps in place."""
    keep_prelast = None
    while True:
        prelast, last = head, head[4]
        last_exchange = None
        while last is not keep_prelast and last[4] is not None:
            te = last[4]
            if last[2] > te[2]:
                prelast[4] = te
                last[4] = te[4]
                te[4] = last
                prelast = te
                last_exchange = prelast
            else:
                prelast, last = last, te
        if last_exchange is None:
            break
        keep_prelast = last_exchange
        if keep_prelast is head[4] or keep_prelast is head:
            break
