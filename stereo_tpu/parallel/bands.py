"""Single-device row-band processing for frames too large to fit whole.

Config 4 (BASELINE.json:10, 2880x1988 at 256 disparities) has a ~1.5G-cell
cost volume; multi-chip runs tile it with halo exchange (tiling.py), but a
SINGLE chip must bound its working set instead. This runner splits the
frame into horizontal bands processed sequentially (a static Python loop
under one jit), each extended by a warm-up halo of rows:

  * horizontal SGM paths are EXACT (bands span the full width, and the
    disparity search needs no vertical support);
  * vertical/diagonal paths start fresh at the extended band edge, the
    same bounded-error trade as the distributed halo mode — measured, not
    assumed (tests compare against the whole-frame pipeline);
  * memory scales with band_rows x W x D instead of H x W x D.

The reference has no counterpart: it assumes the whole volume fits the
GPU (SURVEY.md §5 long-context note — this is the blockwise-processing
analog along the row axis).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import StereoConfig, TileConfig
from ..pipeline.pipeline import (
    StereoResult,
    compute_disparity,
    compute_patch_parts,
)


def build_banded_pipeline(
    cfg: StereoConfig,
    image_shape,
    n_bands: int,
    n_cols: int = 1,
    halo: Optional[int] = None,
    donate: bool = False,
    lr_stitch: Optional[bool] = None,
):
    """Jitted ``(left, right) -> StereoResult`` processing row bands (and
    optionally column patches).

    Args:
      image_shape: (H, W) static frame extent.
      n_bands: horizontal bands (peak memory ~ 1/n_bands).
      n_cols: optional vertical splits with STATIC global x offsets, so the
        Pallas fast path's disparity-range masking and LR framing stay
        frame-exact; only SGM warm-up at patch edges is approximate.
        Two overlap regimes:
          * stitched (default where supported — census/rank costs with the
            cheap-LR re-index): patches carry only the warm-up halo. The
            disparity search reads frame-true right-image context
            (compute_disparity right_context) instead of a +D left halo,
            and the LR check min-combines each patch's PARTIAL right-view
            packed min (PatchParts.qr) across neighbours in XLA, re-gating
            a 2D-wide strip per interior edge — so neither the cost reach
            nor the right-view restack extends the SGM domain. Measured on
            hardware: the halo+D overlap was 22% of config-4 compute.
          * legacy (lr_stitch=False, SAD cost, or exact-LR): halo + D on
            the left for the disparity search, + D on the right when the
            cheap LR re-index is active.
      halo: warm-up rows/cols; default derives from the config like the
        distributed tiling does.
      lr_stitch: force the stitched regime on/off (None = auto).
    """
    h, w = image_shape
    if halo is None:
        halo = TileConfig().resolved_halo(cfg)
    bh = -(-h // n_bands)
    bw = -(-w // n_cols)
    if (n_bands - 1) * bh >= h or (n_cols - 1) * bw >= w:
        raise ValueError(
            f"degenerate split: {n_bands} bands x {n_cols} cols of a "
            f"{h}x{w} frame leaves empty patches; reduce the split counts"
        )
    d = cfg.num_disparities
    ctx_ok = cfg.cost_fn in ("census", "rank")
    # Each patch must span at least the search reach D + min_disparity so
    # one mod-W wrap of the kernel's shift pyramid covers its whole
    # left-spill (and so a position's sources straddle at most two
    # patches).
    min_pw = min(bw + halo, w - (n_cols - 1) * bw + halo) if n_cols > 1 else w
    # halo >= window radius: the stitch's owned-source qr partials (and the
    # right-context descriptors) are only frame-true when border windows are
    # complete inside the halo (round-3 advisor finding; default halo is
    # radius + 16 so only explicit small halos hit this).
    stitch_ok = (
        n_cols > 1 and cfg.lr_check and not cfg.lr_exact
        and cfg.num_paths > 0 and ctx_ok
        and min_pw >= d + int(cfg.min_disparity)
        and halo >= cfg.window_radius
    )
    if lr_stitch is None:
        lr_stitch = stitch_ok
    elif lr_stitch and not stitch_ok:
        raise ValueError(
            "lr_stitch needs n_cols > 1 column patches, the cheap-LR "
            "re-index (lr_check without lr_exact), SGM paths, a "
            "census/rank cost, and a halo covering the descriptor "
            "window radius"
        )
    if lr_stitch:
        return _build_stitched(cfg, (h, w), n_bands, n_cols, halo, donate)
    reach = d + int(cfg.min_disparity)
    hx_lo = halo + reach
    # Both LR modes read rightward across the patch edge (see
    # tiling._halo_widths).
    hx_hi = halo + (reach if cfg.lr_check else 0)

    def banded(left, right):
        if left.shape != (h, w):
            raise ValueError(f"banded pipeline built for {(h, w)}, got {left.shape}")
        row_parts = []
        for b in range(n_bands):
            y0 = b * bh
            y1 = min(h, y0 + bh)
            e0 = max(0, y0 - halo)
            e1 = min(h, y1 + halo)
            col_d = []
            col_v = []
            for c in range(n_cols):
                x0 = c * bw
                x1 = min(w, x0 + bw)
                f0 = max(0, x0 - hx_lo)
                f1 = min(w, x1 + hx_hi)
                res = compute_disparity(
                    left[e0:e1, f0:f1], right[e0:e1, f0:f1], cfg,
                    x_offset=f0, image_width=w,
                )
                col_d.append(res.disp[y0 - e0 : y1 - e0, x0 - f0 : x1 - f0])
                col_v.append(res.valid[y0 - e0 : y1 - e0, x0 - f0 : x1 - f0])
            row_parts.append(
                (jnp.concatenate(col_d, axis=1), jnp.concatenate(col_v, axis=1))
                if n_cols > 1
                else (col_d[0], col_v[0])
            )
        return StereoResult(
            disp=jnp.concatenate([r[0] for r in row_parts], axis=0),
            valid=jnp.concatenate([r[1] for r in row_parts], axis=0),
        )

    donate_argnums = (0, 1) if donate else ()
    return jax.jit(banded, donate_argnums=donate_argnums)


def _build_stitched(
    cfg: StereoConfig, image_shape, n_bands: int, n_cols: int,
    halo: int, donate: bool
):
    """Column-patched runner with warm-up-only overlap + LR stitching.

    Per band of rows, each column patch carries only the warm-up halo in x
    (the legacy regime pays halo + D on the left and halo + D on the right
    per interior edge). Frame-true costs come from ``right_context``
    columns on the right IMAGE (cheap: image bytes, not volume compute);
    the LR check is reassembled in XLA from each patch's PARTIAL
    right-view packed-min map + left-spill (PatchParts.qr / .spill):

      1. the full-width map is the elementwise min of every patch's
         partials, each drawing sources ONLY from the columns the patch
         owns — every (position, source-column) pair is counted exactly
         once, by the patch where that column's matching window is
         complete and its S halo-warmed (sources reach at most D-1
         columns right of a position, and a patch's qr+spill emission
         spans [f0 - SP, f1) with SP >= D, so the owning patch always
         emits the position) — hence the stitched map equals the
         whole-frame map up to SGM warm-up differences on S itself;
      2. pixels within D + min_disparity of an interior edge get their LR
         verdict recomputed from the stitched map (their in-kernel verdict
         saw a truncated patch-local map); everywhere else the in-kernel
         verdict is already frame-true.

    Bit-identical between the golden and Pallas patch paths by
    construction (both emit bit-identical PatchParts and the stitch is
    shared XLA); vs the whole-frame pipeline the error is bounded by SGM
    warm-up, like every banded/tiled mode (tests measure it).
    """
    h, w = image_shape
    bh = -(-h // n_bands)
    bw = -(-w // n_cols)
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    reach = d + md
    big = jnp.float32(3e38)
    edges = [c * bw for c in range(1, n_cols) if c * bw < w]

    from ..ops.postprocess import lr_gate_from_right_map, unpack_partial_min

    def banded(left, right):
        if left.shape != (h, w):
            raise ValueError(
                f"stitched pipeline built for {(h, w)}, got {left.shape}"
            )
        out_d, out_v = [], []
        for b in range(n_bands):
            y0 = b * bh
            y1 = min(h, y0 + bh)
            e0 = max(0, y0 - halo)
            e1 = min(h, y1 + halo)
            sl = slice(y0 - e0, y1 - e0)
            own, maps = [], []
            for c in range(n_cols):
                x0 = c * bw
                x1 = min(w, x0 + bw)
                f0 = max(0, x0 - halo)
                f1 = min(w, x1 + halo)
                ctx = f0 - max(0, f0 - (d - 1 + md))
                p = compute_patch_parts(
                    left[e0:e1, f0:f1], right[e0:e1, f0 - ctx:f1], cfg,
                    x_offset=f0, image_width=w, right_context=ctx,
                    own=(x0 - f0, x1 - f0),
                )
                osl = slice(x0 - f0, x1 - f0)
                own.append(
                    (p.disp[sl, osl], p.ok_nolr[sl, osl],
                     p.lr_bit[sl, osl], p.d0[sl, osl])
                )
                # Full-width padded partials (qr over [f0, f1), spill over
                # [f0 - SP, f0) clipped at the frame edge) for the min.
                qr_pad = jnp.pad(
                    p.qr[sl], ((0, 0), (f0, w - f1)), constant_values=big
                )
                maps.append(qr_pad)
                sp = p.spill.shape[1]
                sa = max(0, f0 - sp)
                if sa < f0:
                    sp_pad = jnp.pad(
                        p.spill[sl, sp - (f0 - sa):],
                        ((0, 0), (sa, w - f0)), constant_values=big,
                    )
                    maps.append(sp_pad)
            disp = jnp.concatenate([o[0] for o in own], axis=1)
            ok_nolr = jnp.concatenate([o[1] for o in own], axis=1)
            gate = jnp.concatenate([o[2] for o in own], axis=1)
            d0 = jnp.concatenate([o[3] for o in own], axis=1)
            full = maps[0]
            for m in maps[1:]:
                full = jnp.minimum(full, m)
            # int16 winner map: the strip re-gate's one-hot select sweeps
            # a [rows, strip, D] slab of this — winners < 2*D fit int16,
            # halving the sweep's HBM traffic (values exact).
            d_r = unpack_partial_min(full, d).astype(jnp.int16)
            for xe in edges:
                a, bb = max(0, xe - reach), min(w, xe + reach)
                g = lr_gate_from_right_map(
                    d0[:, a:bb], d_r, cfg, x_offset=a, image_width=w,
                    r_offset=0,
                ).astype(jnp.int32)
                gate = gate.at[:, a:bb].set(g)
            out_d.append(disp)
            out_v.append((ok_nolr & gate) > 0)
        return StereoResult(
            disp=jnp.concatenate(out_d, axis=0),
            valid=jnp.concatenate(out_v, axis=0),
        )

    donate_argnums = (0, 1) if donate else ()
    return jax.jit(banded, donate_argnums=donate_argnums)
