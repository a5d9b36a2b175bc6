"""End-to-end stereo pipeline: config -> jitted pure function.

Reference call stack (SURVEY.md §3.1): the OpenCL host enqueues one kernel
per stage (census -> cost volume -> per-path SGM scans -> WTA -> subpixel ->
LR-check -> median), crossing the host/device boundary per enqueue.

Here the whole pipeline is ONE pure function traced once under ``jax.jit``
with the config static — XLA sees the full dataflow, fuses stages, and the
only host<->device crossing is the final ``jax.device_get`` (SURVEY.md §3.1
"single boundary crossing"). SGM aggregation is the one stage with a
hand-written kernel (``aggregate`` picks it); every other stage is XLA.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import StereoConfig
from ..ops import (
    apply_postprocess,
    cost_volume,
    lr_consistency,
    median_3x3,
    sgm_aggregate,
)
from ..ops.wta import wta_with_aux


class StereoResult(NamedTuple):
    """Pipeline output pytree.

    disp: [H, W] float32 disparity in left-view coordinates.
    valid: [H, W] bool — False where LR-check / uniqueness rejected the
      match or no in-frame correspondence exists (KITTI convention maps
      invalid to 0 at export time, see eval/).
    """

    disp: jnp.ndarray
    valid: jnp.ndarray


def _sgm_kernel_mode(cfg: StereoConfig, valid, constrain) -> Optional[bool]:
    """Which SGM implementation aggregates this call.

    Returns None for the golden ``lax.scan`` (ops/sgm.py) or the
    ``interpret`` flag for the Triton kernel (ops/pallas/sgm_kernel.py).
    The kernel runs on the GPU for unmasked, unconstrained aggregation:
    whole frames, parallel/bands.py patches and the pyramid's residual
    volume. Masked tiles (parallel/tiling.py), the exact reshard
    (parallel/exact.py) and every call on another platform take the golden
    scan. ``backend="pallas"`` forces the compiled kernel and
    ``"pallas_interpret"`` the interpreted one; a forced backend raises on
    a call the kernel cannot serve instead of falling back.
    """
    if cfg.num_paths == 0 or cfg.backend == "jnp":
        return None
    forced = cfg.backend in ("pallas", "pallas_interpret")
    if valid is not None or constrain is not None:
        if forced:
            raise NotImplementedError(
                "the SGM kernel aggregates unmasked, unconstrained volumes "
                "only; use backend='auto' or 'jnp' for masked tiles and the "
                "exact reshard"
            )
        return None
    if cfg.backend == "pallas_interpret":
        return True
    on_gpu = jax.default_backend() == "gpu"
    if cfg.backend == "pallas" and not on_gpu:
        raise NotImplementedError(
            "backend='pallas' compiles the SGM kernel for a GPU, but JAX "
            f"runs on {jax.default_backend()!r}; use 'pallas_interpret'"
        )
    return False if on_gpu else None


def aggregate(
    vol, cfg: StereoConfig, image=None, valid=None, constrain=None
):
    """SGM-aggregated [H, W, D] int32 volume through the dispatch rule."""
    mode = _sgm_kernel_mode(cfg, valid, constrain)
    if mode is None:
        return sgm_aggregate(
            vol, cfg, image=image, valid=valid, constrain=constrain
        )
    from ..ops.pallas.sgm_kernel import sgm_aggregate_pallas

    return sgm_aggregate_pallas(vol, cfg, image=image, interpret=mode)


def _aggregate(
    left, right, cfg: StereoConfig, valid=None, constrain=None, x_offset=0,
    right_context=0,
):
    """Cost volume + SGM for one reference view. Returns [H, W, D] int."""
    vol = cost_volume(
        left, right, cfg, x_offset=x_offset, right_context=right_context
    )
    if constrain is not None and len(constrain) > 2 and constrain[2] is not None:
        # Cost-volume placement hook: P3 disparity-plane sharding
        # (parallel/exact.py dplane_cost) annotates the freshly built
        # volume D-sharded; XLA inserts the all_to_all to the spatial
        # shardings the SGM pass families request below.
        vol = constrain[2](vol)
        constrain = constrain[:2]
    return aggregate(vol, cfg, image=left, valid=valid, constrain=constrain)


class PatchParts(NamedTuple):
    """Per-column-patch outputs for LR stitching (parallel/bands.py).

    disp: [H, W] f32 final disparity (subpixel + median applied).
    ok_nolr: [H, W] int32 uniqueness gate (LR excluded).
    lr_bit: [H, W] int32 patch-local LR verdict (exact away from the
      patch's column edges; the stitcher replaces it in boundary strips).
    d0: [H, W] int32 integer winner LANE (min_disparity excluded).
    qr: [H, W] f32 packed right-view partial min (right_view_partial_min)
      — min-combinable across patches.
    spill: [H, SP] f32 left-spill partial mins at block-local positions
      [-SP, 0) (right_view_spill) — this patch's contribution to the
      PREVIOUS patch's map.
    """

    disp: jnp.ndarray
    ok_nolr: jnp.ndarray
    lr_bit: jnp.ndarray
    d0: jnp.ndarray
    qr: jnp.ndarray
    spill: jnp.ndarray


def compute_patch_parts(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoConfig,
    x_offset: int = 0,
    image_width: Optional[int] = None,
    right_context: int = 0,
    own=None,
    valid: Optional[jnp.ndarray] = None,
    y_offset=0,
    image_height: Optional[int] = None,
) -> PatchParts:
    """One column patch of a larger frame, gates left open for stitching.

    Each patch emits its PARTIAL right-view packed min instead of paying a
    halo + D x-overlap per interior column edge, and the runner
    (parallel/bands.py, parallel/tiling.py) min-combines neighbours in XLA.
    Unmasked patches aggregate through the SGM kernel on the GPU; masked
    rectangular tiles take the golden scan (``aggregate``'s dispatch).

    ``own``: static block-local (lo, hi) — the column range this patch
    OWNS; its partial-min outputs draw sources only from it, so the
    stitcher's min over patches counts every frame column exactly once
    (and never through a patch's edge-clamped cost fringe). Default: the
    whole patch.

    ``image_height`` declares this a RECTANGULAR tile of a larger frame
    (parallel/tiling.py stitched halo mode): ``x_offset``/``y_offset``
    may then be traced shard_map tile origins and ``valid`` (if given)
    must be exactly the in-frame rectangle; without one it is derived.
    """
    if not (cfg.lr_check and not cfg.lr_exact and cfg.num_paths > 0):
        raise ValueError(
            "compute_patch_parts requires lr_check (re-index mode) + SGM"
        )
    rect = image_height is not None
    if not rect and not isinstance(x_offset, int):
        raise ValueError(
            "compute_patch_parts: static x_offset only (pass image_height "
            "for traced rect-tile origins)"
        )
    from ..ops.postprocess import (
        lr_gate_from_right_map,
        right_view_partial_min,
        right_view_spill,
        unpack_partial_min,
    )

    h, w = left.shape
    iw = image_width if image_width is not None else x_offset + w
    if rect and valid is None:
        valid = _rect_mask(h, w, x_offset, y_offset, iw, image_height)
    s = _aggregate(
        left, right, cfg, valid=valid, x_offset=x_offset,
        right_context=right_context,
    )
    disp, ok, d_int = wta_with_aux(s, cfg)
    d0 = d_int - jnp.int32(cfg.min_disparity)
    ok_nolr = ok.astype(jnp.int32)
    qr = right_view_partial_min(s, cfg, x_offset, iw, src=own)
    spill = right_view_spill(s, cfg, x_offset, iw, src=own)
    d_r = unpack_partial_min(qr, cfg.num_disparities)
    lr_bit = lr_gate_from_right_map(
        d0, d_r, cfg, x_offset=x_offset, image_width=iw,
        r_offset=x_offset,
    ).astype(jnp.int32)
    if cfg.median_filter:
        disp = median_3x3(disp)
    return PatchParts(
        disp=disp, ok_nolr=ok_nolr, lr_bit=lr_bit, d0=d0, qr=qr, spill=spill
    )


def _rect_mask(h, w, x_offset, y_offset, image_width, image_height):
    """[h, w] mask of the block's pixels inside the (possibly larger) frame."""
    ys = y_offset + jnp.arange(h)[:, None]
    xs = x_offset + jnp.arange(w)[None, :]
    return (ys >= 0) & (ys < image_height) & (xs >= 0) & (xs < image_width)


def compute_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: StereoConfig,
    valid: Optional[jnp.ndarray] = None,
    constrain=None,
    x_offset=0,
    image_width: Optional[int] = None,
    y_offset=0,
    image_height: Optional[int] = None,
    right_context: int = 0,
) -> StereoResult:
    """Full pipeline on a rectified pair.

    Args:
      left, right: [H, W] uint8 (or float) rectified grayscale images.
        With ``right_context`` = ctx > 0, right is [H, W + ctx]: ctx
        frame-true columns preceding this block are prepended so the
        disparity search reads real neighbours without extending the SGM
        domain (parallel/bands.py column patches; census/rank costs).
      cfg: static StereoConfig.
      valid: optional [H, W] bool pixel-validity mask (tiled runs pass halo
        masks so SGM carries reset at true image borders, not tile borders).
      x_offset / image_width: global x origin of this block and full image
        width — identity frame by default; tiled runs pass tile coordinates
        so disparity-range masking and LR framing match the untiled
        pipeline bit-exactly.
      y_offset / image_height: same for the y axis. Passing image_height
        declares this block a RECTANGULAR tile of a larger frame; without
        a ``valid`` mask the in-frame rectangle becomes the mask (offsets
        may be traced shard_map tile origins).

    Returns: StereoResult(disp [H, W] f32, valid [H, W] bool).
    """
    if left.ndim != 2 or right.ndim != 2 or (
        left.shape[0] != right.shape[0]
        or left.shape[1] + right_context != right.shape[1]
    ):
        raise ValueError(
            "expected [H, W] left and [H, W + right_context] right, got "
            f"left {left.shape} vs right {right.shape} "
            f"(right_context={right_context})"
        )
    if right_context and (cfg.lr_exact or image_height is not None):
        raise NotImplementedError(
            "right_context supports static column patches only "
            "(no lr_exact flipped pass, no rectangular-tile mode)"
        )

    if image_height is not None and valid is None:
        # Rectangular tile of a larger frame: SGM carries restart at the
        # frame's edges, not the block's.
        valid = _rect_mask(
            left.shape[0], left.shape[1], x_offset, y_offset,
            image_width if image_width is not None else left.shape[1],
            image_height,
        )

    s = _aggregate(
        left, right, cfg, valid=valid, constrain=constrain,
        x_offset=x_offset, right_context=right_context,
    )
    disp, ok, d_int = wta_with_aux(s, cfg)

    if cfg.lr_check and cfg.lr_exact:
        # Exact right-view pass: match with the right image as reference by
        # flipping both images horizontally and swapping roles, then flip
        # the result back — identical to a dedicated right-reference matcher.
        # The consistency compare uses INTEGER winners on both sides
        # (standard SGM: LR precedes subpixel refinement). On a column
        # patch of a larger frame the flipped pass gets the FLIPPED global
        # origin so its disparity-range masking matches the whole-frame
        # right-reference matcher (round-3 review: it previously treated
        # every patch edge as a frame edge).
        iw_f = image_width if image_width is not None else left.shape[1]
        s_r = _aggregate(
            right[:, ::-1], left[:, ::-1], cfg, constrain=constrain,
            x_offset=iw_f - x_offset - left.shape[1],
        )
        _, _, d_int_r = wta_with_aux(s_r, cfg)
        disp_r = d_int_r[:, ::-1]
        ok = ok & lr_consistency(d_int, disp_r, cfg, x_offset, image_width)
        cfg_post = cfg.replace(lr_check=False)
        disp, ok2 = apply_postprocess(disp, ok, s, cfg_post)
        ok = ok & ok2
    else:
        disp, ok = apply_postprocess(
            disp, ok, s, cfg, x_offset, image_width, disp_int=d_int
        )

    return StereoResult(disp=disp, valid=ok)


def build_pipeline(cfg: StereoConfig, donate: bool = False):
    """Return a jitted ``(left, right) -> StereoResult`` for a fixed config.

    Config fields are baked in as static values (the analog of the
    reference's compile-time #defines, SURVEY.md §5).
    """
    fn = functools.partial(compute_disparity, cfg=cfg)
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(fn, donate_argnums=donate_argnums)


def host_postprocess(disp, valid, cfg: StereoConfig):
    """Host-side (numpy) post-filters that map poorly onto XLA.

    Speckle removal (cfg.speckle_max_size > 0) runs as native C++ union-
    find with a Python fallback (stereo_tpu.native); occlusion fill
    (cfg.fill_occlusions) replaces LR-rejected/invalid pixels with the
    smaller of the nearest valid row neighbors (SURVEY.md C11) and counts
    them as estimates. Applied by the CLI and eval harness after device
    compute.
    """
    import numpy as np

    disp = np.asarray(disp)
    valid = np.asarray(valid)
    # Resolution-relative speckle size: blob areas scale with resolution,
    # so cfg.speckle_rel expresses the threshold as a fraction of H*W
    # (max'ed with the absolute knob; either alone may be 0).
    speckle = max(
        cfg.speckle_max_size,
        int(round(cfg.speckle_rel * disp.shape[0] * disp.shape[1])),
    )
    if speckle > 0:
        from ..native import filter_speckles

        disp, valid, _ = filter_speckles(
            disp, valid, cfg.speckle_tau, speckle
        )
    if cfg.fill_occlusions:
        from ..native import fill_invalid_lr

        disp, filled = fill_invalid_lr(disp, valid)
        valid = valid | filled
    return disp, valid
