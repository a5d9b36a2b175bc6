"""SGM path aggregation as a Pallas kernel for NVIDIA GPUs (Triton route).

The hot op of the pipeline (SURVEY.md §2.1 C6). XLA lowers the golden
``lax.scan`` recurrence (ops/sgm.py) to a chain of small kernels per scan
step, so a KITTI frame pays ~4.7k dependent launches on [lines, D] slivers.
Here each path direction is ONE ``pallas_call`` compiled through Triton
(``backend="triton"``), designed for the GPU rather than translated:

  * the grid runs over groups of scanlines; D lies across the threads of a
    program, and a ``fori_loop`` inside the program walks the scan axis with
    the carry ``L[lines, D]`` and its per-line minimum in registers;
  * ``min_k L`` is a reduction over D. The d-1 / d+1 neighbours cross
    threads, which the Triton lowering cannot express with a shift, so each
    step stores L to a two-slot per-program scratch row in global memory,
    synchronises the program's threads (``debug_barrier``) and reads it back
    at offsets -1 / +1. Two slots alternate so one barrier per step suffices;
  * diagonal paths index the volume directly (line k at row y reads column
    k + y - (H-1) or k - y), so no sheared copy of the volume exists;
  * the cost row of step t+1 (and its image intensity, for adaptive P2) is
    loaded during step t, taking the load latency off the recurrence;
  * every pass adds its L into one S buffer through ``input_output_aliases``
    (the first pass writes it), so S is never held as 8 separate volumes.

The cost volume is read as int8 where the unary bound allows (census and rank
costs are at most 63) and int16 otherwise (SAD, at most 255); S is int16
whenever num_paths * (max cost + P2) fits, else int32. D is padded to a power
of two inside the kernel by masking. Results are bit-identical to
``ops.sgm.sgm_aggregate`` (tests/ops/test_pallas_sgm.py runs the kernel in
interpret mode on the CPU; chip_smoke.py compares it on the card).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import StereoConfig

#: Step direction (dy, dx) of each path: the predecessor of (y, x) is
#: (y - dy, x - dx). The first four are the 4-path set.
PATHS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1), (-1, 1))

#: Larger than any path cost: the value of padded disparity lanes and of the
#: neighbour beyond either end of D, so neither can win a minimum.
_BIG = 1 << 20


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _acc_dtype(cfg: StereoConfig):
    """S dtype: int16 when the 8-path sum provably fits, else int32."""
    p2 = max(cfg.p2, cfg.p2_min) if cfg.adaptive_p2 else cfg.p2
    bound = cfg.num_paths * (cfg.max_unary_cost + p2)
    return jnp.int16 if bound < 2**15 else jnp.int32


def _line_coords(dy: int, dx: int, k, t, h: int, w: int):
    """(y, x) of scan step ``t`` on lines ``k`` for path (dy, dx)."""
    if dy == 0:
        return k, jnp.full_like(k, t if dx > 0 else w - 1 - t)
    y = t if dy > 0 else h - 1 - t
    yv = jnp.full_like(k, y)
    if dx == 0:
        return yv, k
    # Diagonal line k runs down-right through x = k + y - (H-1) (dx == dy)
    # or down-left through x = k - y, so k in [0, W+H-1) covers the frame.
    return yv, (k + y - (h - 1)) if dx == dy else (k - y)


def _path_kernel(*refs, dy, dx, first, h, w, d, dp, bl, cfg, interpret):
    if first:
        cost_ref, img_ref, s_ref, scr_ref = refs
    else:
        cost_ref, img_ref, _, s_ref, scr_ref = refs
    n_lines = h if dy == 0 else (w if dx == 0 else w + h - 1)
    n_steps = w if dy == 0 else h
    adaptive = cfg.adaptive_p2
    p1, p2 = cfg.p1, cfg.p2

    pid = pl.program_id(0)
    rows = jnp.arange(bl, dtype=jnp.int32)
    k = pid * bl + rows
    dd = jnp.arange(dp, dtype=jnp.int32)
    lane_ok = (dd < d)[None, :]

    # Masked-off positions point at row 0 on the card. The interpreter
    # emulates a masked store as a scatter of the old values, which would
    # race with a live store to the same cell, so there they point past
    # the last row, where the scatter drops them.
    y_off = h if interpret else 0

    def at(t):
        y, x = _line_coords(dy, dx, k, t, h, w)
        inb = (k < n_lines) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
        return jnp.where(inb, y, y_off), jnp.where(inb, x, 0), inb

    def load_step(t):
        y, x, inb = at(jnp.minimum(t, n_steps - 1))
        c = plgpu.load(
            cost_ref.at[y[:, None], x[:, None], dd[None, :]],
            mask=inb[:, None] & lane_ok, other=0,
        ).astype(jnp.int32)
        if dp > d:
            c = jnp.where(lane_ok, c, _BIG)
        im = (
            plgpu.load(img_ref.at[y, x], mask=inb, other=0)
            if adaptive
            else jnp.zeros((bl,), jnp.int32)
        )
        return c, im

    def step(t, carry):
        l_prev, m, dn, up, im_prev, prev_ok, c, im = carry
        y, x, inb = at(t)
        c_next, im_next = load_step(t + 1)
        if adaptive:
            # Hirschmueller '08 adaptive P2, as in the golden scan: gradients
            # at or below the noise floor keep the full P2.
            g = jnp.abs(im - im_prev) - cfg.adaptive_grad_floor
            p2e = jnp.where(
                g > 0,
                jnp.maximum(cfg.p2_min, jax.lax.div(jnp.int32(p2), jnp.maximum(g, 1))),
                p2,
            )[:, None]
        else:
            p2e = p2
        cand = jnp.minimum(
            jnp.minimum(l_prev, m + p2e), jnp.minimum(dn, up) + p1
        )
        l = jnp.where(prev_ok[:, None], c + cand - m, c)

        where = (y[:, None], x[:, None], dd[None, :])
        smask = inb[:, None] & lane_ok
        acc = l
        if not first:
            acc = acc + plgpu.load(
                s_ref.at[where], mask=smask, other=0
            ).astype(jnp.int32)
        plgpu.store(s_ref.at[where], acc.astype(s_ref.dtype), mask=smask)

        slot = jnp.bitwise_and(t, 1)
        plgpu.store(scr_ref.at[pid, slot, rows[:, None], dd[None, :]], l)
        if not interpret:
            plgpu.debug_barrier()
        dn = plgpu.load(
            scr_ref.at[pid, slot, rows[:, None], jnp.maximum(dd - 1, 0)[None, :]],
            mask=(dd >= 1)[None, :], other=_BIG,
        )
        up = plgpu.load(
            scr_ref.at[pid, slot, rows[:, None], jnp.minimum(dd + 1, dp - 1)[None, :]],
            mask=(dd < dp - 1)[None, :], other=_BIG,
        )
        m = jnp.min(l, axis=1, keepdims=True)
        return l, m, dn, up, im, inb, c_next, im_next

    z = jnp.zeros((bl, dp), jnp.int32)
    c0, im0 = load_step(0)
    init = (
        z, jnp.zeros((bl, 1), jnp.int32), z, z, jnp.zeros((bl,), jnp.int32),
        jnp.zeros((bl,), jnp.bool_), c0, im0,
    )
    jax.lax.fori_loop(0, n_steps, step, init)


def sgm_aggregate_pallas(
    cost: jnp.ndarray,
    cfg: StereoConfig,
    image: jnp.ndarray = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """S(p, d) = sum over 4/8 SGM paths, one Triton pass per direction.

    Args:
      cost: [H, W, D] integer cost volume with values in
        [0, cfg.max_unary_cost] (any integer dtype; read as int8 or int16).
      cfg: static config; num_paths in {0, 4, 8}, fixed or adaptive P2.
      image: [H, W] reference intensities; required when cfg.adaptive_p2.
      interpret: run the kernels in the Pallas interpreter (CPU tests).

    Returns: [H, W, D] int32, bit-identical to ``ops.sgm.sgm_aggregate`` for
    an all-valid frame. Masked or sharding-constrained aggregation stays on
    the golden path (pipeline dispatch).
    """
    if cfg.num_paths == 0:
        return cost
    if cfg.adaptive_p2 and image is None:
        raise ValueError("adaptive_p2 needs the reference image")
    h, w, d = cost.shape
    dp = max(16, _pow2(d))
    bl = max(1, 128 // dp)
    acc = _acc_dtype(cfg)
    cost = cost.astype(cfg.cost_volume_dtype)
    img = (
        image.astype(jnp.int32) if cfg.adaptive_p2
        else jnp.zeros((1, 1), jnp.int32)
    )
    params = plgpu.CompilerParams(num_warps=max(1, min(4, dp // 128)), num_stages=1)
    s = None
    for i, (dy, dx) in enumerate(PATHS[: cfg.num_paths]):
        n_lines = h if dy == 0 else (w if dx == 0 else w + h - 1)
        grid = pl.cdiv(n_lines, bl)
        kern = functools.partial(
            _path_kernel, dy=dy, dx=dx, first=i == 0, h=h, w=w, d=d, dp=dp,
            bl=bl, cfg=cfg, interpret=interpret,
        )
        s, _ = pl.pallas_call(
            kern,
            out_shape=(
                jax.ShapeDtypeStruct((h, w, d), acc),
                jax.ShapeDtypeStruct((grid, 2, bl, dp), jnp.int32),
            ),
            grid=(grid,),
            input_output_aliases={} if i == 0 else {2: 0},
            interpret=interpret,
            backend="triton",
            compiler_params=params,
            name=f"sgm_path_{dy + 1}{dx + 1}",
        )(*((cost, img) if i == 0 else (cost, img, s)))
    return s.astype(jnp.int32)
