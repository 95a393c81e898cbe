"""Run-length-encoded binary masks, COCO-compatible, pure numpy.

The port's own copy of `panoswintransformerobjectdetection_tpu/core/rle.py`
(encode, decode, area, iou, `ann_to_rle`, `polygon_to_rle`).  COCOeval
needs it for crowd annotations (their IoU) and for segm metrics.  The
compressed-string format and the polygon rasterisation follow the public
COCO maskApi specification (column-major runs alternating background and
foreground, a 6-bit delta string; polygon boundaries upsampled 5x then
reduced by scanline), so RLEs made here are interchangeable with
pycocotools' and mask IoU and area match bit for bit.  Host code only.
"""

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict  # {"size": [h, w], "counts": bytes|str|list[int]}


# --------------------------------------------------------------------- codec
def _counts_to_string(counts: Sequence[int]) -> str:
    """Compress raw counts to the COCO 6-bit-chunk delta string."""
    s = []
    cnts = list(counts)
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        while True:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
            if not more:
                break
    return "".join(s)


def _string_to_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        while True:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _raw_counts(rle: RLE) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (str, bytes)):
        c = _string_to_counts(c)
    return np.asarray(c, np.int64)


def encode(mask: np.ndarray, compress: bool = True) -> RLE:
    """Binary (h, w) mask -> RLE (column-major scan, first run = zeros)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # run boundaries
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], diff, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat.size and flat[0] == 1:  # first run must count zeros
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [h, w],
            "counts": _counts_to_string(counts) if compress else counts}


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    counts = _raw_counts(rle)
    total = int(counts.sum())
    flat = np.zeros(h * w, np.uint8)
    pos = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    for i in range(1, len(counts), 2):  # odd runs are foreground
        flat[pos[i]:pos[i + 1]] = 1
    assert total == h * w, f"RLE covers {total} px, mask has {h * w}"
    return flat.reshape((w, h)).T  # column-major


def area(rle: RLE) -> int:
    counts = _raw_counts(rle)
    return int(counts[1::2].sum())


def to_bbox(rle: RLE) -> np.ndarray:
    """RLE -> xywh bbox (matches maskApi rleToBbox)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(),
                     xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
                    np.float32)


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    masks = [decode(r) for r in rles]
    if not masks:
        return {"size": [0, 0], "counts": [0]}
    out = masks[0].astype(bool)
    for m in masks[1:]:
        out = (out & m.astype(bool)) if intersect else (out | m.astype(bool))
    return encode(out)


# --------------------------------------------------------------- polygon fill
def polygon_to_rle(xy: Sequence[float], h: int, w: int) -> RLE:
    """Rasterize one polygon (flat [x0,y0,x1,y1,...]) to an RLE.

    Implements the maskApi `rleFrPoly` algorithm: 5x-upsampled integer
    boundary walk, y-boundary downsampling, then column-major crossing
    fill — identical pixel results to pycocotools `frPyObjects`.
    """
    xy = np.asarray(xy, np.float64)
    k = len(xy) // 2
    scale = 5.0
    x = np.trunc(scale * xy[0::2] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[1::2] + 0.5).astype(np.int64)
    x = np.concatenate([x, x[:1]])
    y = np.concatenate([y, y[:1]])

    # dense boundary points along each segment
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us) if us else np.zeros(0, np.int64)
    v = np.concatenate(vs) if vs else np.zeros(0, np.int64)

    # y-boundary points, downsampled back to pixel grid
    xs_out, ys_out = [], []
    for j in range(1, len(u)):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if np.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
        yd = (yd + 0.5) / scale - 0.5
        yd = min(max(yd, 0.0), float(h))
        xs_out.append(int(xd))
        ys_out.append(int(np.ceil(yd)))

    # crossing fill in column-major order
    a = np.asarray(xs_out, np.int64) * h + np.asarray(ys_out, np.int64)
    a = np.sort(np.concatenate([a, [h * w]]))
    diffs = np.diff(np.concatenate([[0], a]))
    # merge zero diffs into the previous run (double crossings cancel)
    counts: List[int] = [int(diffs[0])]
    j = 1
    while j < len(diffs):
        if diffs[j] > 0:
            counts.append(int(diffs[j]))
            j += 1
        else:
            j += 1
            if j < len(diffs):
                counts[-1] += int(diffs[j])
                j += 1
    return {"size": [h, w], "counts": _counts_to_string(counts)}


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Multiple polygons -> merged binary mask (pycocotools annToMask)."""
    rles = [polygon_to_rle(p, h, w) for p in polys if len(p) >= 6]
    if not rles:
        return np.zeros((h, w), np.uint8)
    return decode(merge(rles))


def ann_to_rle(segm, h: int, w: int) -> RLE:
    """COCO segmentation field (polygons / uncompressed / compressed) -> RLE."""
    if isinstance(segm, list):
        return merge([polygon_to_rle(p, h, w) for p in segm if len(p) >= 6])
    if isinstance(segm.get("counts"), list):
        return {"size": segm["size"],
                "counts": _counts_to_string(segm["counts"])}
    return segm


# ----------------------------------------------------------------------- IoU
def iou(dts: Sequence[RLE], gts: Sequence[RLE],
        iscrowd: Sequence[int]) -> np.ndarray:
    """Mask IoU matrix (D, G); crowd gt -> intersection / dt area
    (maskApi rleIou semantics)."""
    D, G = len(dts), len(gts)
    out = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return out
    dm = [decode(r).astype(bool) for r in dts]
    gm = [decode(r).astype(bool) for r in gts]
    da = np.array([m.sum() for m in dm], np.float64)
    ga = np.array([m.sum() for m in gm], np.float64)
    for i in range(D):
        for j in range(G):
            inter = np.count_nonzero(dm[i] & gm[j])
            union = da[i] if iscrowd[j] else (da[i] + ga[j] - inter)
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def bbox_iou(dts: np.ndarray, gts: np.ndarray,
             iscrowd: Sequence[int]) -> np.ndarray:
    """Box IoU matrix (D, G) on xywh boxes; crowd gt -> IoF
    (maskApi bbIou semantics)."""
    dts = np.asarray(dts, np.float64).reshape(-1, 4)
    gts = np.asarray(gts, np.float64).reshape(-1, 4)
    D, G = len(dts), len(gts)
    if D == 0 or G == 0:
        return np.zeros((D, G), np.float64)
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    da = (dts[:, 2] * dts[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da + np.zeros_like(ga), da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-300), 0.0)
