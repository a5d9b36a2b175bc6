"""Winner-take-all disparity selection + subpixel refinement (golden jnp).

Reference behavior (SURVEY.md §2.1 C7-C8): argmin over the summed volume,
then a parabola fit through the winner's neighboring costs:

    d* = d - (C+ - C-) / (2 (C+ - 2 C0 + C-))

Design: everything is reductions and masked sweeps over the D axis — no
gathers. The winner cost is simply the min, and the +-1 neighbor costs come
from iota-mask reductions, which XLA fuses with the argmin sweep.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import StereoConfig


def wta_disparity(
    s: jnp.ndarray, cfg: StereoConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Select disparities from the aggregated volume.

    Args:
      s: [H, W, D] integer aggregated (or raw) cost volume.
      cfg: static config (subpixel, uniqueness_ratio).

    Returns:
      disp: [H, W] float32 disparity (integer-valued if subpixel disabled).
      valid: [H, W] bool (False where the uniqueness test rejects).
    """
    disp, valid, _ = wta_with_aux(s, cfg)
    return disp, valid


def wta_with_aux(
    s: jnp.ndarray, cfg: StereoConfig
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """wta_disparity plus the integer winner disparity (min_disparity
    included) — the LR consistency check runs on integer maps (standard
    SGM: LR precedes subpixel refinement)."""
    d = s.shape[-1]
    big = (
        jnp.iinfo(s.dtype).max
        if jnp.issubdtype(s.dtype, jnp.integer)
        else jnp.float32(3e38)
    )
    ds = jnp.arange(d)

    c0 = jnp.min(s, axis=-1)                                   # winner cost
    # First-winner argmin via masked index reduction (ties -> smallest d,
    # matching jnp.argmin semantics).
    d0 = jnp.min(
        jnp.where(s == c0[..., None], ds, d), axis=-1
    ).astype(jnp.int32)

    valid = jnp.ones(d0.shape, dtype=bool)
    if cfg.uniqueness_ratio > 0:
        # Best cost outside the winner's +-1 neighborhood must exceed
        # c0 * (1 + ratio), else the match is ambiguous.
        near = jnp.abs(ds[None, None, :] - d0[..., None]) <= 1
        c2 = jnp.min(jnp.where(near, big, s), axis=-1)
        valid = valid & (
            c2.astype(jnp.float32)
            > c0.astype(jnp.float32) * (1.0 + cfg.uniqueness_ratio)
        )

    disp = d0.astype(jnp.float32)
    if cfg.subpixel and d > 1:
        # Neighbor costs via iota-mask reductions (no gathers).
        sel_m = ds[None, None, :] == (d0[..., None] - 1)
        sel_p = ds[None, None, :] == (d0[..., None] + 1)
        cm = jnp.min(jnp.where(sel_m, s, big), axis=-1)
        cp = jnp.min(jnp.where(sel_p, s, big), axis=-1)
        cm_f = cm.astype(jnp.float32)
        cp_f = cp.astype(jnp.float32)
        c0_f = c0.astype(jnp.float32)
        denom = cp_f + cm_f - 2.0 * c0_f
        # Guard the zero-curvature denominator (SURVEY.md §5 race/sanitizer
        # note) and only refine interior winners.
        offset = jnp.where(
            denom > 0, (cm_f - cp_f) / (2.0 * jnp.maximum(denom, 1.0)), 0.0
        )
        offset = jnp.clip(offset, -0.5, 0.5)
        interior = (d0 > 0) & (d0 < d - 1)
        disp = disp + jnp.where(interior, offset, 0.0)

    disp = disp + jnp.float32(cfg.min_disparity)
    disp_int = (d0 + cfg.min_disparity).astype(jnp.float32)
    return disp, valid, disp_int
