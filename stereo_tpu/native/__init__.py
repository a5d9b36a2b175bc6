"""Native (C++) host components, loaded via ctypes.

The reference keeps its runtime and post-filters in C++ (SURVEY.md §1.1);
on the device the compute path is XLA/Pallas, and the native layer covers the
host-side pieces that map poorly onto the compiler: the irregular
union-find speckle filter, the occlusion fill, and fast PNM/PFM dataset
IO. Built on demand with g++ (cached next to the sources); every caller
has a pure-Python fallback, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_LIB_PATH = os.path.join(os.path.dirname(__file__), "_stereo_native.so")
_SOURCES = ["speckle.cpp", "pnm.cpp"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[str]:
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if (
        os.path.exists(_LIB_PATH)
        and os.path.getmtime(_LIB_PATH) >= newest_src
    ):
        return _LIB_PATH
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", _LIB_PATH + ".tmp", *srcs,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return None
    os.replace(_LIB_PATH + ".tmp", _LIB_PATH)
    return _LIB_PATH


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.stpu_filter_speckles.restype = ctypes.c_int64
        lib.stpu_filter_speckles.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int32,
        ]
        lib.stpu_fill_invalid_lr.restype = None
        lib.stpu_fill_invalid_lr.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64,
        ]
        for name in ("stpu_pnm_probe", "stpu_pfm_probe"):
            getattr(lib, name).restype = ctypes.c_int32
        lib.stpu_pnm_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.stpu_pnm_read_gray.restype = ctypes.c_int32
        lib.stpu_pnm_read_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.stpu_pnm_write_gray.restype = ctypes.c_int32
        lib.stpu_pnm_write_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.stpu_pfm_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.stpu_pfm_read.restype = ctypes.c_int32
        lib.stpu_pfm_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def filter_speckles(
    disp: np.ndarray,
    valid: np.ndarray,
    tau: float,
    max_size: int,
    fill_invalid: bool = False,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Remove small connected components of similar disparity.

    Host-side post-filter (cfg.speckle_max_size, SURVEY.md C10/C11).
    Returns (disp, valid, n_removed); inputs are not modified.
    Falls back to a pure-Python BFS if the native build is unavailable.
    """
    disp = np.ascontiguousarray(disp, dtype=np.float32).copy()
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8).copy()
    h, w = disp.shape
    lib = load()
    if lib is not None:
        removed = lib.stpu_filter_speckles(
            _f32p(disp), _u8p(valid_u8), h, w, float(tau), int(max_size),
            np.float32(0.0), 0,
        )
        if fill_invalid:
            lib.stpu_fill_invalid_lr(_f32p(disp), _u8p(valid_u8), h, w)
        return disp, valid_u8.astype(bool), int(removed)
    return _filter_speckles_py(disp, valid_u8, tau, max_size, fill_invalid)


def _filter_speckles_py(disp, valid_u8, tau, max_size, fill_invalid):
    """Pure-Python fallback (slow; used when g++ is unavailable)."""
    h, w = disp.shape
    seen = np.zeros((h, w), dtype=bool)
    removed = 0
    valid = valid_u8.astype(bool)
    for sy in range(h):
        for sx in range(w):
            if seen[sy, sx] or not valid[sy, sx]:
                continue
            stack = [(sy, sx)]
            seen[sy, sx] = True
            comp = []
            while stack:
                y, x = stack.pop()
                comp.append((y, x))
                for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                    ny, nx = y + dy, x + dx
                    if (
                        0 <= ny < h and 0 <= nx < w
                        and not seen[ny, nx] and valid[ny, nx]
                        and abs(disp[y, x] - disp[ny, nx]) <= tau
                    ):
                        seen[ny, nx] = True
                        stack.append((ny, nx))
            if len(comp) < max_size:
                for y, x in comp:
                    valid[y, x] = False
                    removed += 1
    if fill_invalid:
        for y in range(h):
            idx = np.nonzero(valid[y])[0]
            if len(idx) == 0:
                continue
            left = np.full(w, -1.0, np.float32)
            right = np.full(w, -1.0, np.float32)
            last = -1.0
            for x in range(w):
                if valid[y, x]:
                    last = disp[y, x]
                left[x] = last
            last = -1.0
            for x in range(w - 1, -1, -1):
                if valid[y, x]:
                    last = disp[y, x]
                right[x] = last
            for x in range(w):
                if valid[y, x]:
                    continue
                cands = [v for v in (left[x], right[x]) if v >= 0]
                if cands:
                    disp[y, x] = min(cands)
    return disp, valid, removed


def fill_invalid_lr(
    disp: np.ndarray, valid: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Fill invalid pixels from the nearest valid row neighbors.

    Hirschmueller occlusion fill (SURVEY.md C11): each invalid pixel takes
    the SMALLER of the nearest valid disparities to its left and right on
    the same row (occlusions belong to the background). Wired into the
    product surface via ``StereoConfig.fill_occlusions`` →
    ``pipeline.host_postprocess``.

    Returns ``(disp_filled, filled_mask)``; inputs are not modified. A
    pixel is fillable iff its row has at least one valid pixel.
    """
    disp = np.ascontiguousarray(disp, dtype=np.float32).copy()
    valid = np.ascontiguousarray(valid, dtype=bool)
    h, w = disp.shape
    lib = load()
    if lib is not None:
        valid_u8 = valid.astype(np.uint8)
        lib.stpu_fill_invalid_lr(_f32p(disp), _u8p(valid_u8), h, w)
    else:
        # Vectorized numpy fallback: per-row forward/backward fill, then
        # take the smaller of the two candidates (same as the C++ path).
        cols = np.arange(w)[None, :]
        rows = np.arange(h)[:, None]
        li = np.maximum.accumulate(np.where(valid, cols, -1), axis=1)
        lval = np.where(li >= 0, disp[rows, np.clip(li, 0, w - 1)], np.inf)
        ri_rev = np.maximum.accumulate(
            np.where(valid[:, ::-1], cols, -1), axis=1
        )[:, ::-1]
        ri = w - 1 - ri_rev  # column of nearest valid pixel to the right
        rval = np.where(
            ri_rev >= 0, disp[rows, np.clip(ri, 0, w - 1)], np.inf
        )
        cand = np.minimum(lval, rval)
        fill = (~valid) & np.isfinite(cand)
        disp = np.where(fill, cand, disp)
    filled = (~valid) & valid.any(axis=1, keepdims=True)
    return disp, filled


def read_pnm_gray(path: str) -> Optional[np.ndarray]:
    """Native P5/P6 grayscale read; None if unsupported (caller falls back)."""
    lib = load()
    if lib is None:
        return None
    w = ctypes.c_int64()
    h = ctypes.c_int64()
    ch = ctypes.c_int32()
    if lib.stpu_pnm_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(ch)):
        return None
    out = np.empty((h.value, w.value), dtype=np.uint8)
    if lib.stpu_pnm_read_gray(path.encode(), _u8p(out), w.value, h.value):
        return None
    return out


def read_pfm_native(path: str) -> Optional[np.ndarray]:
    """Native single-channel PFM read; None if unsupported."""
    lib = load()
    if lib is None:
        return None
    w = ctypes.c_int64()
    h = ctypes.c_int64()
    if lib.stpu_pfm_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    out = np.empty((h.value, w.value), dtype=np.float32)
    if lib.stpu_pfm_read(path.encode(), _f32p(out), w.value, h.value):
        return None
    return out


def write_pnm_gray(path: str, img: np.ndarray) -> bool:
    lib = load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return lib.stpu_pnm_write_gray(
        path.encode(), _u8p(img), img.shape[1], img.shape[0]
    ) == 0
