"""Coarse-to-fine pyramid SGM (new capability beyond the reference).

Motivation: SGM cost scales with H*W*D. A half-resolution pass costs 1/8th
of the full volume and already localizes disparity to a few pixels; the
full-resolution pass then only searches a small residual window around the
upsampled coarse estimate — total work ~(1/8 + R/D) of the classic
pipeline for a residual range R << D (hierarchical MGM/SGM literature,
PAPERS.md pattern).

Mapping:
  * coarse pass: the ordinary pipeline on 2x2-mean-pooled images with D/2
    disparities (the SGM kernel applies on the GPU);
  * residual pass: census descriptors of BOTH images are computed in
    their own frames (no window distortion), then the right descriptors
    are gathered at x - base(x) - o for offsets o in [-R/2, R/2) — R
    cheap [H, W] gathers instead of a volume gather; the residual volume
    is aggregated by the same SGM dispatch with min_disparity = -R/2 and
    the final disparity is base + residual.

Accuracy: exact where the true disparity lies within R/2 of the coarse
estimate. Two known artifact sources (quantified in eval/benchmarks, a
few percent extra bad-3.0 on discontinuity-heavy scenes): coarse-pass
errors larger than R/2, and SGM smoothing acting in RESIDUAL space, where
continuity across base discontinuities differs from disparity space.
This is the documented speed/quality trade of the fast model family; the
classic model is the reference-parity path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import KITTI_SGM8_128, StereoConfig
from ..ops import census_transform, hamming_distance, median_3x3
from ..ops.wta import wta_with_aux
from ..pipeline.pipeline import StereoResult, aggregate, compute_disparity
from .base import StereoModel


def _pool2(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean pooling (pads odd extents by edge replication)."""
    h, w = img.shape
    hp, wp = h + (h % 2), w + (w % 2)
    p = jnp.pad(img.astype(jnp.float32), ((0, hp - h), (0, wp - w)), mode="edge")
    pooled = p.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))
    return pooled.astype(jnp.uint8)


def _upsample2(base: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Nearest-neighbor 2x upsample of a coarse disparity, scaled by 2."""
    up = jnp.repeat(jnp.repeat(base, 2, axis=0), 2, axis=1)
    return up[:h, :w] * 2.0


def _local_minmax_center(base: jnp.ndarray, k: int = 5) -> jnp.ndarray:
    """Center of the local disparity spread: (minpool_k + maxpool_k) / 2.

    At discontinuities the upsampled coarse estimate can be off by more
    than the residual half-window; centering the search on the midpoint of
    the local min/max lets a window of R cover a local spread of up to R
    (standard hierarchical-stereo trick).
    """
    r = k // 2
    p = jnp.pad(base, ((r, r), (r, r)), mode="edge")
    h, w = base.shape
    mn = base
    mx = base
    for dy in range(k):
        for dx in range(k):
            win = p[dy : dy + h, dx : dx + w]
            mn = jnp.minimum(mn, win)
            mx = jnp.maximum(mx, win)
    return jnp.round((mn + mx) * 0.5)


def _residual_cost_volume(
    cl: jnp.ndarray,
    cr: jnp.ndarray,
    base_i: jnp.ndarray,
    half: int,
    r: int,
) -> jnp.ndarray:
    """vol[y, x, o] = hamming(cl[y, x], cr[y, clip(x - base - (o - half))]).

    One [H, W] ``take_along_axis`` gather per offset o. Indices that clip at
    either frame edge imply a total disparity outside [0, D) or x - d < 0,
    which the caller overwrites with max_unary_cost (PyramidSGM._forward).
    """
    w = base_i.shape[1]
    xs = jnp.arange(w)[None, :]

    def plane(o):
        src = jnp.clip(xs - base_i - (o - half), 0, w - 1)
        cr_s = jnp.take_along_axis(cr, src[:, :, None], axis=1)
        return hamming_distance(cl, cr_s)

    return jax.vmap(plane, out_axes=2)(jnp.arange(r))      # [H, W, R]


class PyramidSGM(StereoModel):
    name = "pyramid"

    def __init__(
        self,
        cfg: StereoConfig = KITTI_SGM8_128,
        residual_range: int = 16,
        census_window=None,
    ):
        """``census_window``: None (default) inherits ``cfg``'s window —
        an explicitly passed config is never silently overridden.
        Speed-trade callers opt into the 1-word ``(5, 5)``
        descriptor explicitly (bench.py's pyramid row does): the tuned
        presets' 2-word 9x7 census roughly doubles both the coarse cost
        pass and the residual gather (Hamming words scale with bits),
        while the pyramid's quality is dominated by its own
        approximation artifacts, not descriptor bits."""
        super().__init__(cfg)
        if residual_range % 2:
            raise ValueError("residual_range must be even")
        self.residual_range = residual_range
        if census_window is not None:
            self.cfg = self.cfg.replace(census_window=census_window)

    def _forward(self, left, right):
        cfg = self.cfg
        r = self.residual_range
        h, w = left.shape

        # --- coarse pass at half resolution, D/2 ---
        coarse_cfg = cfg.replace(
            num_disparities=max(8, cfg.num_disparities // 2),
            lr_check=False,
            median_filter=True,
            subpixel=False,
        )
        res_c = compute_disparity(_pool2(left), _pool2(right), coarse_cfg)
        base = _upsample2(res_c.disp, h, w)
        base = _local_minmax_center(base)

        # --- residual pass at full resolution over [-r/2, r/2) ---
        cl = census_transform(left, cfg.census_window)
        cr = census_transform(right, cfg.census_window)

        half = r // 2
        # Coarse disparities are >= 0 by construction; the clamp also pins
        # any future negative-min_disparity coarse config to the precondition
        # of _residual_cost_volume.
        base = jnp.clip(base, 0, cfg.num_disparities - 1)
        base_i = jnp.round(base).astype(jnp.int32)
        vol = _residual_cost_volume(cl, cr, base_i, half, r)
        # invalid where the total disparity leaves the image or the search
        # range of the classic model
        total = base[:, :, None] + (
            jnp.arange(r)[None, None, :] - half
        )
        xs = jnp.arange(w)[None, :, None]
        invalid = (
            (xs - total < 0)
            | (total < 0)
            | (total > cfg.num_disparities - 1)
        )
        maxc = jnp.int32(cfg.max_unary_cost)
        vol = jnp.where(invalid, maxc, vol)

        res_cfg = cfg.replace(
            num_disparities=r, min_disparity=-half, lr_check=False
        )
        # Residual aggregation is plain SGM over an [H, W, R] volume: the
        # pipeline's dispatch sends it to the SGM kernel on the GPU.
        s = aggregate(vol, res_cfg, image=left)
        disp_r, ok, _ = wta_with_aux(s, res_cfg)
        disp = base + disp_r
        ok = ok & (disp >= 0) & (disp <= cfg.num_disparities - 1)
        if cfg.median_filter:
            disp = median_3x3(disp)
        return StereoResult(disp=disp, valid=ok)

    def build(self):
        return jax.jit(self._forward)
