"""Disparity post-processing: LR consistency, median filter, invalid fill.

Reference behavior (SURVEY.md §2.1 C9-C11): compute a right-view disparity
map, invalidate pixels where |d_L(x) - d_R(x - d_L(x))| > tau, then a 3x3
median filter; invalid pixels are marked (KITTI convention: 0 / mask).

Design: the right-view map comes from re-indexing the already aggregated
left volume, S_R(y, x, d) = S_L(y, x + d, d) — one re-index instead of a
second full pipeline pass (cfg.lr_exact=True runs the exact second pass in
pipeline.py). The median is a 9-element sorting network on shifted maps,
fully elementwise.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import StereoConfig
from .wta import wta_disparity


def right_disparity_from_volume(
    s: jnp.ndarray, cfg: StereoConfig, x_offset=0, image_width=None
) -> jnp.ndarray:
    """Right-view WTA disparity by re-indexing the left aggregated volume.

    S_R(y, x_r, d) = S_L(y, x_r + md + d, d) — left pixel x_r + md + d
    matches right pixel x_r at lane d, so index x_r IS the right-image
    column (round-3 review: the md term was missing, skewing every
    min_disparity != 0 cheap-LR lookup by md columns). Out-of-frame
    samples get a cost above any achievable aggregate so they never win.
    ``x_offset`` / ``image_width`` describe where this block sits in the
    global image (tiled runs); defaults treat the block as the whole
    image.
    """
    import jax

    h, w, d = s.shape
    md = int(cfg.min_disparity)
    if image_width is None:
        image_width = w
    big = (
        jnp.iinfo(s.dtype).max // 2
        if jnp.issubdtype(s.dtype, jnp.integer)
        else jnp.float32(1e38)
    )

    # Per-disparity shift instead of a 3D gather: XLA lowers the vmapped
    # 1-D take with static shifts to slices.
    def plane(s_d, dd):
        idx = jnp.minimum(jnp.arange(w) + md + dd, w - 1)
        shifted = jnp.take(s_d, idx, axis=1)          # [H, W]
        oof = (x_offset + jnp.arange(w) + md + dd) >= image_width
        return jnp.where(oof[None, :], big, shifted)

    s_r = jax.vmap(plane, in_axes=(2, 0), out_axes=2)(s, jnp.arange(d))
    sub_cfg = cfg.replace(subpixel=False, uniqueness_ratio=0.0)
    disp_r, _ = wta_disparity(s_r, sub_cfg)
    return disp_r


def spill_width(num_disparities: int, min_disparity: int = 0) -> int:
    """Left-spill width: covers every position with an in-block source.

    Position p (block-local, < 0) has sources p + md + d for lanes
    d < D, so the deepest reachable position is -(D + md - 1); rounded
    up to a multiple of 128 columns (at least 128).
    """
    need = num_disparities + int(min_disparity)
    return max(128, -(-need // 128) * 128)


def right_view_partial_min(
    s: jnp.ndarray, cfg: StereoConfig, x_offset=0, image_width=None,
    src=None,
) -> jnp.ndarray:
    """Packed right-view PARTIAL min over in-block anti-diagonals.

    m_r(x) = min over d of S(x+md+d, d) * PD + d (md = min_disparity, so
    index x is the RIGHT-image column), with lanes masked BIG where the
    source column x+md+d leaves the allowed source range (``src``:
    block-local (lo, hi), default the block's true extent — the stitcher
    passes the patch's OWNED columns so every frame column is counted by
    exactly one patch) or the global frame. PD = pow2 >= D, so (value,
    first-argmin) ride one f32 number — the golden twin of the fused
    kernel's ``emit_qr`` output (ops/pallas/sgm_kernel.py
    _v_fused_kernel), bit-identical because all quantities are integers
    below 2^24. Partials from adjacent column patches min-combine into
    the frame-exact right-view winner (parallel/bands.py LR stitching).

    Returns [H, W] float32 (BIG where every lane is masked).
    """
    import jax

    h, w, d = s.shape
    md = int(cfg.min_disparity)
    if image_width is None:
        image_width = w
    lo, hi = src if src is not None else (0, w)
    pd = 1 << max(0, (d - 1).bit_length())
    big = jnp.float32(3e38)
    xs = jnp.arange(w)

    def plane(s_d, dd):
        idx = jnp.clip(xs + md + dd, 0, w - 1)
        q = jnp.take(s_d, idx, axis=1).astype(jnp.float32) * pd + dd
        bad = (
            (xs + md + dd < lo) | (xs + md + dd >= hi)
            | (x_offset + xs + md + dd >= image_width)
        )
        return jnp.where(bad[None, :], big, q)

    q_r = jax.vmap(plane, in_axes=(2, 0), out_axes=2)(s, jnp.arange(d))
    return jnp.min(q_r, axis=2)


def right_view_spill(
    s: jnp.ndarray, cfg: StereoConfig, x_offset=0, image_width=None,
    src=None,
) -> jnp.ndarray:
    """Packed right-view partial mins at positions LEFT of this block.

    Column j of the [H, SP] result (SP = spill_width(D, md)) is
    min over d of S(j - SP + md + d, d) * PD + d over THIS block's
    allowed sources only (``src`` as in right_view_partial_min) — the
    left-spill
    companion covering block-local positions [-SP, 0), i.e. this block's
    contribution to the PREVIOUS column patch's right-view map
    (parallel/bands.py stitching). Golden twin of the fused kernel's
    spill output (bit-identical; same masks).
    """
    import jax

    h, w, d = s.shape
    md = int(cfg.min_disparity)
    if image_width is None:
        image_width = w
    lo, hi = src if src is not None else (0, w)
    pd = 1 << max(0, (d - 1).bit_length())
    sp = spill_width(d, md)
    big = jnp.float32(3e38)
    js = jnp.arange(sp)

    def plane(s_d, dd):
        srcs = js - sp + md + dd
        idx = jnp.clip(srcs, 0, w - 1)
        q = jnp.take(s_d, idx, axis=1).astype(jnp.float32) * pd + dd
        bad = (srcs < lo) | (srcs >= hi) | (x_offset + srcs >= image_width)
        return jnp.where(bad[None, :], big, q)

    q_r = jax.vmap(plane, in_axes=(2, 0), out_axes=2)(s, jnp.arange(d))
    return jnp.min(q_r, axis=2)


def unpack_partial_min(m_r: jnp.ndarray, num_disparities: int) -> jnp.ndarray:
    """Right-view winner LANE index from a packed (partial) min map.

    Columns where every lane was masked (m_r still BIG) take winner 0 —
    the fused kernel's convention for all-masked rows.
    """
    pd = 1 << max(0, (num_disparities - 1).bit_length())
    d_r = m_r - jnp.floor(m_r * jnp.float32(1.0 / pd)) * jnp.float32(pd)
    return jnp.where(m_r < jnp.float32(3e38), d_r, 0.0)


def lr_gate_from_right_map(
    d0: jnp.ndarray,
    d_r: jnp.ndarray,
    cfg: StereoConfig,
    x_offset=0,
    image_width=None,
    r_offset=0,
    r_delta=None,
) -> jnp.ndarray:
    """LR gate for left winners against an explicit right-view winner map.

    Mirrors the fused kernel's in-kernel check exactly: both maps hold
    LANE indices (min_disparity excluded); a pixel survives iff
    |d0 - d_R(x - d0 - md)| <= lr_tau and the correspondence is globally
    in frame. ``d0`` is [H, Wl] at global origin ``x_offset``; ``d_r`` is
    [H, Wr] at global origin ``r_offset`` (the stitched full-frame map, or
    a patch-local partial). Gather-free: one-hot select over D shifted
    slices (see lr_consistency).

    ``r_delta`` (static int) overrides ``x_offset - r_offset`` in the
    per-plane shift. Tiled callers whose offsets are traced device
    indices but whose DIFFERENCE is algebraically static must pass it:
    a traced shift turns the per-plane ``jnp.take`` into an XLA gather,
    while a static one lowers to slices.

    Returns [H, Wl] bool.
    """
    import jax

    h, wl = d0.shape
    wr = d_r.shape[1]
    if image_width is None:
        image_width = x_offset + wl
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    if r_delta is None:
        r_delta = x_offset - r_offset
    d0i = d0.astype(jnp.int32)
    xs = jnp.arange(wl)[None, :]
    xr_g = x_offset + xs - d0i - md
    in_frame = (xr_g >= 0) & (xr_g < image_width)

    def plane(dd):
        idx = jnp.clip(jnp.arange(wl) + r_delta - dd - md, 0, wr - 1)
        return jnp.take(d_r, idx, axis=1)

    stack = jax.vmap(plane, out_axes=2)(jnp.arange(d))       # [H, Wl, D]
    onehot = d0i[:, :, None] == jnp.arange(d)[None, None, :]
    d_r_at = jnp.sum(jnp.where(onehot, stack, 0), axis=-1)
    ok = jnp.abs(d0i.astype(jnp.float32) - d_r_at.astype(jnp.float32)) <= (
        jnp.float32(cfg.lr_tau)
    )
    return ok & in_frame


def lr_consistency(
    disp_l: jnp.ndarray, disp_r: jnp.ndarray, cfg: StereoConfig, x_offset=0,
    image_width=None,
) -> jnp.ndarray:
    """Left-right consistency mask.

    A left pixel survives iff |d_L(x) - d_R(x - round(d_L(x)))| <= tau and
    its right-image correspondence is in frame (globally, when the block is
    a tile of a larger image).

    Gather-free: since the lookup offset is always one of the D disparity
    integers, d_R(x - d_L) is a one-hot select over the D shifted copies
    of the right map — plain slices + one [H, W, D] elementwise sweep
    instead of a ``take_along_axis`` gather on the [H, W] maps.
    Winners outside [min_disparity, min_disparity + D) (possible only for
    out-of-contract inputs) clamp to the nearest disparity plane.

    Returns: [H, W] bool validity.
    """
    import jax

    h, w = disp_l.shape
    if image_width is None:
        image_width = w
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    xs = jnp.arange(w)[None, :]
    xr = jnp.round(xs - disp_l).astype(jnp.int32)
    xr_global = x_offset + xr
    in_frame = (xr_global >= 0) & (xr_global < image_width)

    shift = jnp.clip(xs - xr, md, md + d - 1)        # == round(d_L) in range

    def plane(dd):
        idx = jnp.clip(jnp.arange(w) - dd, 0, w - 1)
        return jnp.take(disp_r, idx, axis=1)         # [H, W] slice-shift

    stack = jax.vmap(plane, out_axes=2)(md + jnp.arange(d))   # [H, W, D]
    onehot = shift[:, :, None] == (md + jnp.arange(d))[None, None, :]
    d_r_at = jnp.sum(jnp.where(onehot, stack, 0), axis=-1)
    ok = jnp.abs(disp_l - d_r_at) <= cfg.lr_tau
    return ok & in_frame


def median_3x3(disp: jnp.ndarray) -> jnp.ndarray:
    """3x3 median filter over the 9 shifted maps (edge-padded).

    Uses the fixed 19-comparator median-of-9 exchange network (Paeth) —
    pure elementwise min/max, which XLA fuses into one kernel.
    """
    p = jnp.pad(disp, ((1, 1), (1, 1)), mode="edge")
    h, w = disp.shape
    v = [p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]

    def sort2(i, j):
        lo = jnp.minimum(v[i], v[j])
        hi = jnp.maximum(v[i], v[j])
        v[i], v[j] = lo, hi

    for i, j in (
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ):
        sort2(i, j)
    return v[4]


def apply_postprocess(
    disp: jnp.ndarray,
    valid: jnp.ndarray,
    s: jnp.ndarray,
    cfg: StereoConfig,
    x_offset=0,
    image_width=None,
    disp_int=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """LR-check + median, per config. Returns (disp, valid).

    The LR check compares INTEGER winner disparities (disp_int; falls back
    to rounding disp) — standard SGM order: consistency before subpixel.
    """
    if cfg.lr_check and not cfg.lr_exact:
        disp_r = right_disparity_from_volume(s, cfg, x_offset, image_width)
        d_l = disp_int if disp_int is not None else jnp.round(disp)
        valid = valid & lr_consistency(d_l, disp_r, cfg, x_offset, image_width)
    if cfg.median_filter:
        disp = median_3x3(disp)
    return disp, valid
