"""Matching-cost computation and cost-volume construction (golden jnp).

Reference behavior (SURVEY.md §2.1 C3-C5): SAD block matching or
census-Hamming matching cost, materialized as the H x W x D cost volume —
"the central tensor" (BASELINE.json:5).

Design notes:
  * Layout is [H, W, D] with D innermost: a pixel's D costs are contiguous,
    and every SGM path direction streams the same layout (SURVEY.md §7
    hard-part 5).
  * The d-shift fans out via ``jax.vmap`` over a statically padded right
    image/descriptor — one fused gather, no Python-level D loop at trace time.
  * Out-of-frame samples (x - d < 0) get the maximum unary cost so they never
    win WTA; d=0 is always in frame, keeping argmin well-defined.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import StereoConfig
from .census import census_transform, hamming_distance, rank_transform


def _shifted_stack(
    x: jnp.ndarray, num_disparities: int, ctx: int = 0, min_disparity: int = 0
) -> jnp.ndarray:
    """Stack right-view samples for lanes d = 0..D-1 along a new last axis.

    Lane d searches disparity ``min_disparity + d`` (the reported winner
    is lane + min_disparity, ops/wta.py — round-3 review: the volume
    previously ignored min_disparity, so every md != 0 output was the
    md = 0 winner relabeled +md).

    Args:
      x: [H, W + ctx, ...] per-pixel quantity from the right view. The
        leading ``ctx`` columns are extra LEFT context (frame-true columns
        preceding this block — parallel/bands.py column patches pass the
        true neighbours so interior costs stay frame-exact without running
        the downstream SGM over them).
    Returns:
      [H, W, D, ...] where out[y, x, d] = in[y, x + ctx - md - d], with
      the index clamped to 0 (the caller masks the globally invalid
      region).
    """
    h, wc = x.shape[:2]
    w = wc - ctx
    d = num_disparities
    md = min_disparity

    def take(shift):
        idx = jnp.maximum(jnp.arange(w) + ctx - md - shift, 0)
        return jnp.take(x, idx, axis=1)

    stacked = jax.vmap(take, out_axes=2)(jnp.arange(d))
    return stacked


def _invalid_mask(
    h: int, w: int, num_disparities: int, x_offset=0, min_disparity: int = 0
) -> jnp.ndarray:
    """[H, W, D] bool, True where global x - md - d < 0 (no right sample).

    ``x_offset`` is this block's global x origin — 0 for whole images; tiled
    runs (parallel/tiling.py) pass the tile origin (possibly a traced scalar)
    so border invalidation matches the untiled pipeline bit-exactly.
    """
    xs = x_offset + jnp.arange(w)[None, :, None]
    ds = min_disparity + jnp.arange(num_disparities)[None, None, :]
    return jnp.broadcast_to(xs < ds, (h, w, num_disparities))


def box_sum(img: jnp.ndarray, window: Tuple[int, int]) -> jnp.ndarray:
    """Windowed box sum with edge-replicated borders, via separable cumsum.

    Args:
      img: [H, W] or [H, W, C].
    Returns:
      Same shape; each pixel holds the sum of the wy x wx window around it.
    """
    wy, wx = window
    ry, rx = wy // 2, wx // 2
    pad = ((ry, ry), (rx, rx)) + ((0, 0),) * (img.ndim - 2)
    p = jnp.pad(img, pad, mode="edge")

    # Separable prefix sums: sum over rows then cols.
    cs = jnp.cumsum(p, axis=0)
    cs = jnp.pad(cs, ((1, 0),) + ((0, 0),) * (img.ndim - 1))
    rowsum = cs[wy:, :] - cs[:-wy, :]           # [H, W + 2rx, ...]
    cs2 = jnp.cumsum(rowsum, axis=1)
    cs2 = jnp.pad(cs2, ((0, 0), (1, 0)) + ((0, 0),) * (img.ndim - 2))
    return cs2[:, wx:] - cs2[:, :-wx]


def sad_cost_volume(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig, x_offset=0,
    right_context: int = 0,
) -> jnp.ndarray:
    """SAD block-matching cost volume.

    cost[y, x, d] = mean |L(y, x+i, x+j) - R(y-d, ...)| over the SAD window,
    in [0, 255] (normalized by window area so penalties are scale-comparable
    with the census path).

    ``right_context``: extra frame-true columns prepended to ``right``
    (see _shifted_stack); with context >= D-1 the interior costs match the
    whole-frame volume exactly.

    Returns: [H, W, D] int32.
    """
    h, w = left.shape
    d = cfg.num_disparities
    l32 = left.astype(jnp.int32)
    r32 = right.astype(jnp.int32)
    r_stack = _shifted_stack(
        r32, d, right_context, int(cfg.min_disparity)
    )                                                      # [H, W, D]
    ad = jnp.abs(l32[:, :, None] - r_stack)                # [H, W, D]
    area = cfg.sad_window[0] * cfg.sad_window[1]
    summed = box_sum(ad, cfg.sad_window) // area           # [H, W, D]
    invalid = _invalid_mask(h, w, d, x_offset, int(cfg.min_disparity))
    return jnp.where(invalid, jnp.int32(cfg.max_unary_cost), summed)


def census_cost_volume(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig, x_offset=0,
    right_context: int = 0,
) -> jnp.ndarray:
    """Census-Hamming cost volume (SURVEY.md C2+C4+C5 fused at trace level).

    ``right_context``: extra frame-true columns prepended to ``right``;
    with context >= D-1 + census radius the interior costs match the
    whole-frame volume exactly (the transform clamps its window at the
    wide slice edge, so the outermost radius columns need real backing).

    Returns: [H, W, D] int32, values in [0, window_bits].
    """
    h, w = left.shape
    d = cfg.num_disparities
    cl = census_transform(left, cfg.census_window)         # [H, W, words]
    cr = census_transform(right, cfg.census_window)
    cr_stack = _shifted_stack(
        cr, d, right_context, int(cfg.min_disparity)
    )                                                      # [H, W, D, words]
    cost = hamming_distance(cl[:, :, None, :], cr_stack)   # [H, W, D]
    invalid = _invalid_mask(h, w, d, x_offset, int(cfg.min_disparity))
    return jnp.where(invalid, jnp.int32(cfg.max_unary_cost), cost)


def rank_cost_volume(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig, x_offset=0,
    right_context: int = 0,
) -> jnp.ndarray:
    """Rank-transform cost volume: |rank_l(x) - rank_r(x - d)|.

    The refined-rank family (PAPERS.md: Fully Parallel SGM with Refined
    Rank Method) — scalar per-pixel descriptor, absolute-difference cost.
    ``right_context`` as in census_cost_volume.
    Returns [H, W, D] int32, values in [0, window_area - 1].
    """
    h, w = left.shape
    d = cfg.num_disparities
    rl = rank_transform(left, cfg.census_window)
    rr = rank_transform(right, cfg.census_window)
    rr_stack = _shifted_stack(rr, d, right_context, int(cfg.min_disparity))
    cost = jnp.abs(rl[:, :, None] - rr_stack)
    invalid = _invalid_mask(h, w, d, x_offset, int(cfg.min_disparity))
    return jnp.where(invalid, jnp.int32(cfg.max_unary_cost), cost)


def cost_volume(
    left: jnp.ndarray, right: jnp.ndarray, cfg: StereoConfig, x_offset=0,
    right_context: int = 0,
) -> jnp.ndarray:
    """Dispatch on cfg.cost_fn. Returns [H, W, D] int32."""
    if cfg.cost_fn == "census":
        return census_cost_volume(left, right, cfg, x_offset, right_context)
    if cfg.cost_fn == "rank":
        return rank_cost_volume(left, right, cfg, x_offset, right_context)
    return sad_cost_volume(left, right, cfg, x_offset, right_context)
