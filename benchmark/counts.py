"""Compulsory operations and bytes of each stage, from shapes alone.

A roofline share has to read the same work whatever implements the stage, so
these count what the stage cannot avoid, never what today's code moves:

cost volume
  bytes: both uint8 images read once, the volume written once at the
  narrowest exact type (int8 while the largest cost fits, else int16).
  ops: the census compares (bits per pixel, both images) and, per
  (pixel, disparity), one XOR and one popcount per 32-bit descriptor word.
SGM
  bytes: the volume read once, S written once as int16 (8 paths of at most
  max cost + P2 each fit under 2**15).
  ops: 9 per (pixel, disparity, path), counted from the recurrence
  L(p,d) = C(p,d) + min(L(q,d), L(q,d-1)+P1, L(q,d+1)+P1, m+P2) - m:
  2 adds of P1, 3 minimums, the add of C, the subtraction of m, the step of
  the minimum over d that makes m, and the add into S (m + P2 is per pixel
  and not counted per disparity).
select and post
  bytes: S read once, the f32 disparity and the bool mask written once.
  ops: per (pixel, disparity) the left minimum, the right-view minimum and
  the uniqueness minimum; per pixel the 19 compare-exchanges (38 ops) of
  the 3x3 median.
"""

from __future__ import annotations

from typing import Dict, Tuple


def stage_counts(config: dict) -> Dict[str, Tuple[float, float]]:
    """{layer: (ops, bytes)} for one frame of a configuration file."""
    st = config["stereo"]
    h, w = config["frame"]["height"], config["frame"]["width"]
    n, d = h * w, st["num_disparities"]
    wy, wx = st["census_window"]
    bits = wy * wx - 1
    words = (bits + 31) // 32
    vol = 1 if bits <= 127 else 2
    paths = st["num_paths"]
    return {
        "cost_volume": (2 * n * bits + 2 * n * d * words, 2 * n + n * d * vol),
        "sgm": (9 * n * d * paths, n * d * vol + n * d * 2),
        "select_post": (3 * n * d + 38 * n, n * d * 2 + n * 4 + n),
    }


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The larger of ops over the ALU peak and bytes over HBM bandwidth."""
    return max(ops / peaks["alu_ops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
