"""The COCOeval matcher in C++ (`cocoeval.cpp`), loaded with ctypes.

The port's counterpart of `panoswintransformerobjectdetection_tpu/native/
__init__.py` (`get_lib`, `native_match_class`, `native_match_image`).  The
library is built with `g++ -O3 -shared -fPIC` at first use into
`build/native/` at the root of the checkout (listed in `.gitignore`), never
next to the source; its file name carries a hash of the source, so an edited
source is rebuilt.  Without `g++`, or when the build fails, `get_lib()` is
None and the callers run their numpy twin of the same loop
(`core/cocoeval._match_image`, `core/evaluation._match_class`).

`calls` counts the matches each of the two ran ("native", "numpy"), so
that a caller can require the C++ matcher.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cocoeval.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"

calls = {"native": 0, "numpy": 0}
build_error: Optional[str] = None
_lib: Optional[ctypes.CDLL] = None
_tried = False

_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.POINTER(ctypes.c_int64)


def record(which: str) -> None:
    """Count one match made by `which` ("native" or "numpy")."""
    calls[which] += 1


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcocoeval_{digest}.so"


def get_lib() -> Optional[ctypes.CDLL]:
    """The matcher's library, built on the first call; None if it cannot be
    built (the reason is kept in `build_error`)."""
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    target = library_path()
    try:
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, text=True, timeout=300)
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"{type(e).__name__}: {getattr(e, 'stderr', None) or e}"
        return None
    lib.match_class.argtypes = [_F32, ctypes.c_int32, _F32, ctypes.c_int32, ctypes.c_float,
                                _U8]
    lib.match_class.restype = None
    lib.match_image.argtypes = [_F64, ctypes.c_int32, _F64, ctypes.c_int32, ctypes.c_int32,
                                _U8, _U8, _I64, _U8]
    lib.match_image.restype = None
    _lib = lib
    return _lib


def native_match_class(det_boxes, gt_boxes, iou_thr):
    """det_boxes (D, 4) sorted by score, descending; gt_boxes (G, 4) ->
    tp (D,) bool, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    det = np.ascontiguousarray(det_boxes, np.float32)
    gt = np.ascontiguousarray(gt_boxes, np.float32)
    tp = np.zeros(len(det), np.uint8)
    lib.match_class(det.ctypes.data_as(_F32), len(det), gt.ctypes.data_as(_F32), len(gt),
                    ctypes.c_float(float(iou_thr)), tp.ctypes.data_as(_U8))
    return tp.astype(bool)


def native_match_image(iou_thrs, ious, gt_ignore, iscrowd):
    """COCOeval's matcher (crowd-aware, per threshold) for one (image,
    category).  ious (D, G), gt columns sorted non-ignored first.  Returns
    (dtm (T, D) int64 gt index or -1, dt_ig (T, D) bool), or None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    iou = np.ascontiguousarray(ious, np.float64)
    D, G = iou.shape
    T = len(thrs)
    gt_ig = np.ascontiguousarray(gt_ignore, np.uint8)
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    dtm = np.empty((T, D), np.int64)
    dt_ig = np.empty((T, D), np.uint8)
    lib.match_image(thrs.ctypes.data_as(_F64), T, iou.ctypes.data_as(_F64), D, G,
                    gt_ig.ctypes.data_as(_U8), crowd.ctypes.data_as(_U8),
                    dtm.ctypes.data_as(_I64), dt_ig.ctypes.data_as(_U8))
    return dtm, dt_ig.astype(bool)
