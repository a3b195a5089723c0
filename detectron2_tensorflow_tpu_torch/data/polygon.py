"""Polygon rasterization equal to ``cv2.fillPoly`` pixel for pixel.

The JAX package draws COCO polygons with ``cv2.fillPoly(mask, [pts], 1)`` on
vertices rounded to integers (``LINE_8``, no shift). This is OpenCV's
algorithm in numpy and Python integers, step for step (``drawing.cpp``):

* every edge is first drawn as an 8-connected line (``LineIterator`` with
  ``leftToRight``: Bresenham from the left end, with the error term and
  tie rule of OpenCV, after Cohen-Sutherland clipping to the image with
  OpenCV's ``clipLine`` rounding);
* the non-horizontal edges are then filled by a scanline walk in 16.16
  fixed point (``CollectPolyEdges`` / ``FillEdgeCollection``): each edge
  runs from its upper vertex over rows ``[y0, y1)`` with a slope truncated
  toward zero; the active edges, sorted by ``(y0, x, dx)`` when they enter
  and re-sorted by ``x`` (bubble sort, strict swaps) after each row, are
  paired in order, and each pair fills ``[floor(x_left), floor(x_right)]``.

Self-intersecting and concave polygons take the same pairing (even-odd), so
they match too; ``tests/test_torch_coco.py`` holds it against ``cv2``.

:func:`fill_ellipse` is ``cv2.ellipse(img, center, axes, 0, 0, 360, value,
-1)``, OpenCV's ``EllipseEx`` step for step: ``ellipse2Poly``'s vertices
every ``delta`` degrees (5 for axes of 15 px and more) from OpenCV's
float sine table (its values to 7 decimals), rounded to 16.16 fixed point,
then ``FillConvexPoly``: each edge drawn by ``Line2`` (the fixed-point
line walk), then the two-edge scanline fill. ``tests/test_torch_panoptic_data.py``
holds it against ``cv2`` over every axis pair the synthetic tool draws.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's SinTable: sin of 0 .. 450 degrees as float literals of 7 decimals.
SIN_TABLE = [float(np.float32(round(math.sin(math.radians(i)), 7))) for i in range(451)]


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine``: ``(inside, x1, y1, x2, y2)``, the segment
    clipped to ``[0, w) x [0, h)`` (its ends moved as OpenCV moves them even
    when it misses the image)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img: np.ndarray, p1, p2, value) -> None:
    """OpenCV's ``Line`` with 8-connectivity (``LineIterator``, leftToRight)."""
    h, w = img.shape[:2]
    x1, y1 = p1
    x2, y2 = p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    delta_x = delta_y = 1
    if dx < 0:  # leftToRight: start from the left end
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    if dy < 0:
        dy, delta_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        delta_x, delta_y = delta_y, delta_x
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    minus_shift, plus_shift, minus_step, plus_step = delta_x, 0, 0, delta_y
    if vert:
        plus_step, plus_shift = plus_shift, plus_step
        minus_step, minus_shift = minus_shift, minus_step
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        neg = err < 0
        err += minus_delta + (plus_delta if neg else 0)
        x += minus_shift + (plus_shift if neg else 0)
        y += minus_step + (plus_step if neg else 0)


def fill_poly(img: np.ndarray, pts, value) -> None:
    """``cv2.fillPoly(img, [pts], value)`` for one contour of integer
    vertices ``pts [N, 2]`` (x, y), in place."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    if not pts:
        return
    h, w = img.shape[:2]
    edges = []  # [y0, y1, x, dx] in 16.16 fixed point along x
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _line(img, (x0, y0), (x1, y1), value)
        if y0 != y1:
            # The edge runs through pixel centres, or, where its line was
            # clipped, through the clipped ends, extended to the vertex rows.
            cx0, cy0, cx1, cy1 = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
                _, tx0, ty0, tx1, ty1 = _clip_line(w, h, x0, y0, x1, y1)
                if ty0 != ty1:
                    cx0, cy0, cx1, cy1 = tx0 << XY_SHIFT, ty0, tx1 << XY_SHIFT, ty1
            dxe = _tdiv(cx1 - cx0, cy1 - cy0)
            if y0 < y1:
                edges.append([y0, y1, cx0 + (y0 - cy0) * dxe, dxe])
            else:
                edges.append([y1, y0, cx1 + (y1 - cy1) * dxe, dxe])
        x0, y0 = x1, y1
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, h)
    active = []
    nxt = 0
    for y in range(edges[0][0], y_max):
        active = [e for e in active if e[1] != y]
        # New edges enter before any active edge whose x is not below theirs.
        merged = []
        j = 0
        while nxt < len(edges) and edges[nxt][0] == y:
            e = edges[nxt]
            while j < len(active) and active[j][2] < e[2]:
                merged.append(active[j])
                j += 1
            merged.append(e)
            nxt += 1
        merged.extend(active[j:])
        active = merged
        for k in range(0, len(active) - 1, 2):
            a, b = active[k], active[k + 1]
            if y >= 0:
                lo, hi = (b[2], a[2]) if a[2] > b[2] else (a[2], b[2])
                xa, xb = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT
                if xa < w and xb >= 0:
                    img[y, max(xa, 0):min(xb, w - 1) + 1] = value
            a[2] += a[3]
            b[2] += b[3]
        # Bubble sort by x with strict swaps, as OpenCV re-sorts the list.
        n = len(active)
        while True:
            swapped = False
            for k in range(n - 1):
                if active[k][2] > active[k + 1][2]:
                    active[k], active[k + 1] = active[k + 1], active[k]
                    swapped = True
            if not swapped:
                break


def _put(img: np.ndarray, x: int, y: int, value) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = value


def _line2(img: np.ndarray, p1, p2, value) -> None:
    """OpenCV's ``Line2``: a line between 16.16 fixed-point ends, clipped to
    the image, stepping one pixel along its longer axis (the ends swapped to
    walk forward), both end pixels drawn."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
        ax = abs(dx)
        step = _tdiv((y2 - y1) << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
        ay = abs(dy)
        step = _tdiv((x2 - x1) << XY_SHIFT, ay | 1)
        count = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    _put(img, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT, value)
    x1 += half
    y1 += half
    if abs(dx) > abs(dy):
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> XY_SHIFT, value)
            x1 += 1
            y1 += step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> XY_SHIFT, y1, value)
            x1 += step
            y1 += 1


def _fill_convex_poly(img: np.ndarray, v, value) -> None:
    """OpenCV's ``FillConvexPoly`` (``LINE_8``, shift 16) of the 16.16 vertices ``v``."""
    h, w = img.shape[:2]
    n = len(v)
    half = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, value)
        p0 = p
    imin = min(range(n), key=lambda i: (v[i][1], i))
    xmin = (min(p[0] for p in v) + half) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + half) >> XY_SHIFT
    ymin = (v[imin][1] + half) >> XY_SHIFT
    ymax = (max(p[1] for p in v) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Two edge walkers from the top vertex, one each way round: [idx, di, x, dx, ye].
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n  # OpenCV's budget of edge steps; spent, the fill stops
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, idx = e[0], (e[0] + e[1]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[0], e[2], e[4] = idx, xs, ty
                    e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    break
                idx0, idx = idx, (idx + e[1]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            xx1, xx2 = (left[2] + half) >> XY_SHIFT, (right[2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def fill_ellipse(img: np.ndarray, center, axes, value) -> None:
    """``cv2.ellipse(img, center, axes, 0, 0, 360, value, -1)`` (integer
    centre and half axes, no rotation, ``LINE_8``), in place."""
    (cx, cy), (ax, ay) = center, (abs(axes[0]), abs(axes[1]))
    big = max(ax, ay)
    delta = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    v = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        px = float(cx << XY_SHIFT) + float(ax << XY_SHIFT) * SIN_TABLE[450 - a]
        py = float(cy << XY_SHIFT) + float(ay << XY_SHIFT) * SIN_TABLE[a]
        qx = int(np.rint(px / XY_ONE)) << XY_SHIFT
        qy = int(np.rint(py / XY_ONE)) << XY_SHIFT
        q = (qx + int(np.rint(px - qx)), qy + int(np.rint(py - qy)))
        if not v or q != v[-1]:
            v.append(q)
    if len(v) == 1:
        v.append(v[0])
    _fill_convex_poly(img, v, value)
