"""Semi-Global Matching path aggregation (golden jnp implementation).

Reference behavior (SURVEY.md §2.1 C6, Hirschmueller 2005/2008 [K]): for each
path direction r,

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1, L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

summed over 4 paths (left/right/up/down) or 8 (plus diagonals).

Design (SURVEY.md §3.2):
  * Each direction is a ``jax.lax.scan`` along the scan axis with carry
    ``L[lines, D]`` — the D-wide recurrence is vectorized and all
    scanlines of a pass run in parallel.
  * Diagonal paths shear the volume so the diagonal becomes a column
    (SURVEY.md §7 hard-part 2): sheared[y, x'] = cost[y, x' + y - (H-1)]
    turns the down-right diagonal into a vertical scan; validity masks feed
    the scan so carries reset at image borders (fresh start: L = C).
  * The Triton kernel in ops/pallas/sgm_kernel.py implements the same
    recurrence for the GPU; this function is its bit-exact oracle and the
    path for masked tiles and the exact reshard.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import StereoConfig


def _scan_direction(
    cost_seq: jnp.ndarray,
    prev_valid_seq: jnp.ndarray,
    img_seq: Optional[jnp.ndarray],
    cfg: StereoConfig,
) -> jnp.ndarray:
    """Run the SGM recurrence along the leading axis.

    Args:
      cost_seq: [N, L, D] int32 — N scan steps, L parallel scanlines.
      prev_valid_seq: [N, L] bool — whether step t's spatial predecessor is a
        real in-image pixel (False resets the carry: L = C).
      img_seq: [N, L] int32 intensities along the scan, or None. Only used
        when cfg.adaptive_p2 (P2 / |dI| scaling).

    Returns:
      [N, L, D] int32 aggregated path costs.
    """
    p1 = jnp.int32(cfg.p1)
    p2 = jnp.int32(cfg.p2)
    n, lines, d = cost_seq.shape
    use_grad = cfg.adaptive_p2 and img_seq is not None

    def step(carry, xs):
        l_prev, img_prev = carry
        if use_grad:
            c, prev_valid, img_cur = xs
            # adaptive_grad_floor: gradients at or below the sensor-noise
            # floor count as flat (full P2). The classic P2/|dI| divides by
            # the NOISE amplitude in flat regions (sigma=6 -> |dI| ~ 7 ->
            # P2/7), collapsing the smoothing textureless content needs
            # (measured on the hard suite, docs/tuning.md).
            grad = jnp.abs(img_cur - img_prev) - jnp.int32(
                cfg.adaptive_grad_floor
            )
            p2_eff = jnp.where(
                grad > 0,
                jnp.maximum(jnp.int32(cfg.p2_min), p2 // jnp.maximum(grad, 1)),
                p2,
            )[:, None]
        else:
            c, prev_valid = xs[:2]
            img_cur = img_prev
            p2_eff = p2

        m = jnp.min(l_prev, axis=-1, keepdims=True)           # [L, 1]
        dn = jnp.concatenate([l_prev[:, :1], l_prev[:, :-1]], axis=1) + p1
        up = jnp.concatenate([l_prev[:, 1:], l_prev[:, -1:]], axis=1) + p1
        cand = jnp.minimum(
            jnp.minimum(l_prev, m + p2_eff), jnp.minimum(dn, up)
        )
        l_new = c + cand - m
        l_new = jnp.where(prev_valid[:, None], l_new, c)
        return (l_new, img_cur), l_new

    init_l = cost_seq[0] * 0  # zeros; first step has prev_valid = False
    init_img = (
        img_seq[0] * 0 if use_grad else jnp.zeros((lines,), jnp.int32)
    )
    xs = (
        (cost_seq, prev_valid_seq, img_seq)
        if use_grad
        else (cost_seq, prev_valid_seq)
    )
    _, out = jax.lax.scan(step, (init_l, init_img), xs)
    return out


def _horizontal(cost, valid, img, cfg, reverse: bool) -> jnp.ndarray:
    """Left-to-right (reverse=False) or right-to-left path. cost: [H, W, D]."""
    seq = jnp.swapaxes(cost, 0, 1)                   # [W, H, D]
    v = jnp.swapaxes(valid, 0, 1)                    # [W, H]
    im = jnp.swapaxes(img, 0, 1) if img is not None else None
    if reverse:
        seq, v = seq[::-1], v[::-1]
        im = im[::-1] if im is not None else None
    prev_valid = jnp.concatenate([jnp.zeros_like(v[:1]), v[:-1]], axis=0)
    out = _scan_direction(seq, prev_valid, im, cfg)
    if reverse:
        out = out[::-1]
    return jnp.swapaxes(out, 0, 1)


def _vertical(cost, valid, img, cfg, reverse: bool) -> jnp.ndarray:
    """Top-to-bottom / bottom-to-top path. cost: [H, W, D] scans axis 0."""
    seq, v, im = cost, valid, img
    if reverse:
        seq, v = seq[::-1], v[::-1]
        im = im[::-1] if im is not None else None
    prev_valid = jnp.concatenate([jnp.zeros_like(v[:1]), v[:-1]], axis=0)
    out = _scan_direction(seq, prev_valid, im, cfg)
    if reverse:
        out = out[::-1]
    return out


def _shear(x: jnp.ndarray, sign: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shear rows so diagonals become columns.

    sign=+1: sheared[y, x'] = x[y, x' + y - (H-1)]  (down-right diagonal).
    sign=-1: sheared[y, x'] = x[y, x' - y]          (down-left diagonal).

    Returns (sheared [H, W+H-1, ...], valid [H, W+H-1] bool).
    """
    h, w = x.shape[:2]
    wp = w + h - 1
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(wp)[None, :]
    src = xs + ys - (h - 1) if sign > 0 else xs - ys
    valid = (src >= 0) & (src < w)
    src_c = jnp.clip(src, 0, w - 1)
    sheared = jnp.take_along_axis(
        x, src_c.reshape(h, wp, *([1] * (x.ndim - 2))), axis=1
    )
    return sheared, valid


def _unshear(x: jnp.ndarray, sign: int, w: int) -> jnp.ndarray:
    """Inverse of _shear: recover [H, W, ...] from [H, W+H-1, ...]."""
    h = x.shape[0]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    src = xs - ys + (h - 1) if sign > 0 else xs + ys
    return jnp.take_along_axis(
        x, src.reshape(h, w, *([1] * (x.ndim - 2))), axis=1
    )


def sgm_aggregate(
    cost: jnp.ndarray,
    cfg: StereoConfig,
    image: Optional[jnp.ndarray] = None,
    valid: Optional[jnp.ndarray] = None,
    constrain=None,
) -> jnp.ndarray:
    """Sum of SGM path costs S(p, d) = sum_r L_r(p, d).

    Args:
      cost: [H, W, D] int32 matching-cost volume.
      cfg: static config (num_paths in {0, 4, 8}, P1/P2, adaptive_p2).
      image: [H, W] intensities for adaptive P2 (optional).
      valid: [H, W] bool mask of real pixels (tiled runs pass halo masks);
        None means all valid.
      constrain: optional (rows_local_fn, cols_local_fn) pair of pytree ->
        pytree sharding annotators (parallel/exact.py). rows_local_fn is
        applied to the inputs of row-scan passes (shards H so each full row
        is device-local), cols_local_fn to column-scan and sheared-diagonal
        inputs (shards the scan-parallel axis). XLA inserts the all_to_all
        reshard between pass families — the Ulysses analog (SURVEY.md P6).

    Returns:
      [H, W, D] int32 summed volume. num_paths=0 returns cost unchanged.
    """
    if cfg.num_paths == 0:
        return cost
    h, w, _ = cost.shape
    if valid is None:
        valid = jnp.ones((h, w), dtype=bool)
    img = image.astype(jnp.int32) if image is not None else None
    if not cfg.adaptive_p2:
        img = None

    rows_local = constrain[0] if constrain else (lambda t: t)
    cols_local = constrain[1] if constrain else (lambda t: t)

    c_r, v_r, i_r = rows_local((cost, valid, img))
    s = _horizontal(c_r, v_r, i_r, cfg, reverse=False)
    s = s + _horizontal(c_r, v_r, i_r, cfg, reverse=True)

    c_c, v_c, i_c = cols_local((cost, valid, img))
    s_v = _vertical(c_c, v_c, i_c, cfg, reverse=False)
    s_v = s_v + _vertical(c_c, v_c, i_c, cfg, reverse=True)
    if cfg.num_paths == 8:
        for sign in (+1, -1):
            c_sh, v_geom = _shear(c_c, sign)
            v_sh = _shear(v_c, sign)[0] & v_geom
            i_sh = _shear(i_c, sign)[0] if i_c is not None else None
            c_sh, v_sh, i_sh = cols_local((c_sh, v_sh, i_sh))
            d_out = _vertical(c_sh, v_sh, i_sh, cfg, reverse=False)
            d_out = d_out + _vertical(c_sh, v_sh, i_sh, cfg, reverse=True)
            s_v = s_v + _unshear(d_out, sign, w)
    return s + s_v
