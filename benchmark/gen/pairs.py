"""Seeded synthetic stereo pairs for the benchmark's traffic.

A copy of the program's pair generator (``stereo_tpu.data.make_pair``), cut to
the scene families the benchmark uses and without the occlusion mask, which
nothing here reads. It is kept apart so that no change to the program can
move the frames the benchmark measures: for the same arguments it yields the
same left and right images, byte for byte (a CPU test checks this).

Construction: the right image is a textured scene; the left image samples it
at ``left(y, x) = right(y, x - d(y, x))``, where ``d`` is the left-view
disparity, rounded to whole pixels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class Pair(NamedTuple):
    left: np.ndarray   # [H, W] uint8
    right: np.ndarray  # [H, W] uint8
    gt_disp: np.ndarray  # [H, W] float32 left-view disparity


def _disparity_field(kind: str, h: int, w: int, max_disp: int, rng):
    if kind == "constant":
        return np.full((h, w), max_disp // 2, dtype=np.float32)
    if kind == "shapes":
        # A background plane and three fronto-parallel objects in front.
        disp = np.full((h, w), max(1.0, 0.15 * max_disp), dtype=np.float32)
        for _ in range(3):
            cy, cx = rng.integers(h // 6, 5 * h // 6), rng.integers(
                w // 6, 5 * w // 6
            )
            ry, rx = rng.integers(h // 10, h // 4), rng.integers(
                w // 10, w // 4
            )
            level = rng.uniform(0.4 * max_disp, max_disp)
            ys, xs = np.ogrid[:h, :w]
            if rng.random() < 0.5:
                mask = (np.abs(ys - cy) < ry) & (np.abs(xs - cx) < rx)
            else:
                mask = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 1.0
            disp = np.where(mask & (level > disp), level, disp)
        return disp
    raise ValueError(f"unknown scene kind {kind!r}")


def _texture(texture: str, h: int, w: int, rng):
    if texture == "noise":
        return rng.integers(0, 256, size=(h, w)).astype(np.float32)
    if texture == "cloud":
        # Band-limited smooth texture plus random dots, closer to natural
        # images than dots alone.
        base = rng.normal(size=(h // 8 + 2, w // 8 + 2))
        ys = np.linspace(0, base.shape[0] - 1.001, h)
        xs = np.linspace(0, base.shape[1] - 1.001, w)
        y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        up = (
            base[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + base[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + base[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + base[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        up = (up - up.min()) / (np.ptp(up) + 1e-9)
        dots = rng.integers(0, 256, size=(h, w)).astype(np.float32)
        return 0.65 * (up * 255.0) + 0.35 * dots
    raise ValueError(f"unknown texture {texture!r}")


def _sample_right(right: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """left(y, x) = right(y, x - d), linear between columns."""
    h, w = right.shape
    xs = np.arange(w)[None, :].astype(np.float32) - disp
    x0 = np.floor(xs).astype(np.int64)
    frac = xs - x0
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    rows = np.arange(h)[:, None]
    return (1.0 - frac) * right[rows, x0c] + frac * right[rows, x1c]


def make_pair(
    shape: Tuple[int, int],
    max_disp: int,
    kind: str = "shapes",
    texture: str = "cloud",
    seed: int = 0,
) -> Pair:
    """One rectified pair with whole-pixel disparities in [0, max_disp]."""
    h, w = shape
    rng = np.random.default_rng(seed)
    disp = _disparity_field(kind, h, w, max_disp, rng)
    disp = np.clip(np.round(disp), 0, max_disp).astype(np.float32)
    right = _texture(texture, h, w, rng)
    left = _sample_right(right, disp)
    return Pair(
        left=np.clip(left, 0, 255).astype(np.uint8),
        right=np.clip(right, 0, 255).astype(np.uint8),
        gt_disp=disp,
    )


def pair_seed(seed: int, index: int) -> int:
    """Seed of pool pair ``index`` in a run started with ``--seed seed``.

    Any whole number is a valid run seed; it is reduced modulo 2**64 so that
    negative and very large seeds map to a fixed 64-bit key.
    """
    ss = np.random.SeedSequence([seed % (1 << 64), index])
    return int(ss.generate_state(1, dtype=np.uint64)[0])
