"""Halo-exchange tile parallelism via shard_map (SURVEY.md §2.2 P2 + P5).

The signature distributed component: the H x W image is sharded over mesh
axes ('ty', 'tx'); each device matches its tile extended by a halo strip
fetched from its neighbors with `jax.lax.ppermute` (the ring/neighbor
topology of ring attention applied to stereo tiles, P5). The halo serves
three roles:

  * window support for census/SAD (radius pixels);
  * SGM carry warm-up: path costs enter the tile interior already settled,
    bounding the error of not propagating carries across tiles exactly
    (the trade SURVEY.md §7 hard-part 3 says to measure — benchmarks compare
    against the bit-exact reshard mode in parallel/exact.py);
  * disparity-search support: the cost at column x references right-image
    samples at x - d, so the x-halo on the low side is widened by D (and on
    the high side too when the cheap LR-check re-index is active, which
    gathers S at x + d).

Out-of-image regions of a tile (padding or beyond the frame) are marked
invalid so SGM carries reset at TRUE image borders only. Per-tile disparity
maps reassemble through the output sharding: requesting replicated outputs
makes XLA emit the all_gather of BASELINE.json:5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import StereoConfig, TileConfig
from ..ops import median_3x3
from ..pipeline.pipeline import (
    StereoResult,
    compute_disparity,
    compute_patch_parts,
)

try:  # jax >= 0.7 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _halo_exchange(
    x: jnp.ndarray, axis: int, axis_name: str, lo: int, hi: int
) -> jnp.ndarray:
    """Extend a per-device block with `lo`/`hi` rows of neighbor data.

    Halos wider than one block fetch strips from k-hop neighbors with one
    ppermute per hop. Strips with no source (frame boundary, or hops past
    the mesh edge) arrive zero-filled; the caller's validity mask marks
    them out-of-image and remaps them to edge replicas.
    """
    n = lax.axis_size(axis_name)
    block = x.shape[axis]

    def strips(total: int, from_prev: bool):
        """Halo strips ordered outward-in for lo, inward-out for hi."""
        out = []
        k = 1
        remaining = total
        while remaining > 0:
            size = min(block, remaining)
            if from_prev:
                # k-hop previous neighbor's trailing `size` rows.
                edge = lax.slice_in_dim(x, block - size, block, axis=axis)
                perm = [(i, i + k) for i in range(n - k)] if k < n else []
            else:
                edge = lax.slice_in_dim(x, 0, size, axis=axis)
                perm = [(i + k, i) for i in range(n - k)] if k < n else []
            out.append(lax.ppermute(edge, axis_name, perm) if perm else jnp.zeros_like(edge))
            remaining -= size
            k += 1
        return out

    parts = []
    if lo > 0:
        parts.extend(reversed(strips(lo, from_prev=True)))
    parts.append(x)
    if hi > 0:
        parts.extend(strips(hi, from_prev=False))
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else x


def _cropped_median(disp_c, iy, ix, bh, bw, h, w):
    """3x3 median on a CROPPED tile with a 1-px neighbor disparity halo.

    Runs after cropping so edge pixels see final neighbor disparities
    (running inside the extended tile would mix values computed at
    out-of-image replica pixels, where the untiled pipeline replicates
    the edge disparity). Shared by the legacy and stitched tile bodies.
    """
    e = _halo_exchange(disp_c, 0, "ty", 1, 1)
    e = _halo_exchange(e, 1, "tx", 1, 1)
    ys1 = iy * bh - 1 + jnp.arange(bh + 2)[:, None]
    xs1 = ix * bw - 1 + jnp.arange(bw + 2)[None, :]
    e = e[
        jnp.clip(ys1, 0, h - 1) - (iy * bh - 1),
        jnp.clip(xs1, 0, w - 1) - (ix * bw - 1),
    ]
    return median_3x3(e)[1:-1, 1:-1]


def _halo_widths(cfg: StereoConfig, tile_cfg: TileConfig) -> Tuple[int, int, int]:
    """(halo_y, halo_x_lo, halo_x_hi) in pixels."""
    halo = tile_cfg.resolved_halo(cfg)
    reach = cfg.num_disparities + int(cfg.min_disparity)
    x_lo = halo + reach                   # cost needs right(x - md - d)
    # BOTH LR modes read rightward across the tile edge: the cheap
    # re-index restacks S at x + md + d, and the exact flipped pass
    # searches left samples at x + md + d (round-3 review: lr_exact
    # previously got no high halo).
    x_hi = halo + (reach if cfg.lr_check else 0)
    return halo, x_lo, x_hi


def stitch_supported(cfg: StereoConfig, bw: int, halo: Optional[int] = None) -> bool:
    """Whether the warm-up-only stitched tile regime applies.

    Census/rank costs (the cost kernels' right_context path), the cheap
    re-index LR, SGM paths, and tiles at least D + md wide (so a
    right-view position's sources straddle at most two tiles). When
    ``halo`` is given it must also cover the descriptor window radius:
    the stitch's owned-source qr partials are only frame-true if
    descriptors at owned columns near the patch edge see complete
    windows (round-3 advisor finding — a user halo below the radius
    would silently widen the error model beyond SGM warm-up, so such
    configs fall back to the legacy regime / raise on explicit request).
    """
    return (
        cfg.lr_check
        and not cfg.lr_exact
        and cfg.num_paths > 0
        and cfg.cost_fn in ("census", "rank")
        and bw >= cfg.num_disparities + int(cfg.min_disparity)
        and (halo is None or halo >= cfg.window_radius)
    )


def padded_extent(size: int, tiles: int) -> int:
    """Smallest multiple of `tiles` >= size."""
    return -(-size // tiles) * tiles


def make_tile_fn(
    cfg: StereoConfig,
    h: int,
    w: int,
    bh: int,
    bw: int,
    halo_y: int,
    halo_x_lo: int,
    halo_x_hi: int,
    trivial: bool = False,
):
    """Per-tile pipeline body run under shard_map over mesh axes ('ty','tx').

    Shared by the single-pair tiled pipeline below and the batched stream
    pipeline (parallel/stream.py), which vmaps it over a frame axis.

    ``trivial=True`` marks a 1x1 tile grid with no padding: the tile IS the
    frame, so no halo exchange and no validity mask — the SGM kernel serves
    it (a single-card 'batch'-only stream would otherwise aggregate on the
    golden scan).
    """
    if trivial:

        def tile_fn_trivial(l_blk, r_blk):
            return compute_disparity(l_blk, r_blk, cfg)

        return tile_fn_trivial

    def tile_fn(l_blk, r_blk):
        # shard_map passes [bh, bw] blocks; build the halo-extended
        # working tile and its global-coordinate validity mask.
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")

        y0 = iy * bh - halo_y
        x0 = ix * bw - halo_x_lo
        ys = y0 + jnp.arange(bh + 2 * halo_y)[:, None]
        xs = x0 + jnp.arange(bw + halo_x_lo + halo_x_hi)[None, :]
        valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)

        # Out-of-image halo positions (zero-filled by ppermute at frame
        # edges) are remapped to the nearest in-image pixel so window
        # ops see the same edge-replicated borders as the untiled
        # pipeline. The clamped coordinate always lies inside this
        # tile's extended block (edge tiles own the frame border).
        ys_l = jnp.clip(ys, 0, h - 1) - y0
        xs_l = jnp.clip(xs, 0, w - 1) - x0

        def extend(img):
            e = _halo_exchange(img, 0, "ty", halo_y, halo_y)
            e = _halo_exchange(e, 1, "tx", halo_x_lo, halo_x_hi)
            return e[ys_l, xs_l]

        l_ext = extend(l_blk)
        r_ext = extend(r_blk)

        # The median runs AFTER cropping, on a 1-px halo of final
        # disparity values: running it inside the extended tile would
        # mix disparities computed at out-of-image replica pixels,
        # whereas the untiled pipeline replicates the edge *disparity*.
        # The mask makes SGM carries restart at the frame's edges, so the
        # tile aggregates on the golden scan (pipeline.aggregate).
        cfg_tile = cfg.replace(median_filter=False)
        res = compute_disparity(
            l_ext, r_ext, cfg_tile, valid=valid, x_offset=x0, image_width=w,
            y_offset=y0, image_height=h,
        )
        crop = (
            slice(halo_y, halo_y + bh),
            slice(halo_x_lo, halo_x_lo + bw),
        )
        disp_c = res.disp[crop]
        valid_c = res.valid[crop] & valid[crop]

        if cfg.median_filter:
            disp_c = _cropped_median(disp_c, iy, ix, bh, bw, h, w)

        return StereoResult(disp=disp_c, valid=valid_c)

    return tile_fn


def make_stitched_tile_fn(
    cfg: StereoConfig,
    h: int,
    w: int,
    bh: int,
    bw: int,
    halo: int,
):
    """Stitched-LR tile body: warm-up-only x-overlap (the
    distributed twin of parallel/bands.py's stitched regime).

    The legacy tile pays halo + D of x-halo on BOTH sides (cost reach on
    the low side, the LR re-index's right-view restack on the high side)
    — at KITTI scale on a 2-wide tx axis that is ~45% extra compute per
    tile. Here the SGM domain carries only the warm-up halo:

      * the cost kernels read ctx = D - 1 + md frame-true right-IMAGE
        columns (exchanged image bytes, not volume compute);
      * each tile emits its packed right-view partial min over its OWNED
        columns + left-spill (compute_patch_parts), neighbors exchange
        three thin strips along 'tx' (prev's qr tail, next's spill tail,
        next's qr head — O(D) columns each), and the frame-exact
        right-view winner map is min-assembled locally;
      * pixels within D + md of a tile edge get their LR verdict
        recomputed against the assembled map; elsewhere the in-kernel
        verdict is already frame-true.

    Error model identical to the legacy halo mode (SGM warm-up only);
    with P1 = P2 = 0 the tiled result is bit-identical to the untiled
    pipeline (tests/distributed/test_parallel.py).
    """
    d = cfg.num_disparities
    md = int(cfg.min_disparity)
    ctx = d - 1 + md
    reach = d + md
    big = jnp.float32(3e38)
    cfg_tile = cfg.replace(median_filter=False)

    def tile_fn(l_blk, r_blk):
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")
        ntx = lax.axis_size("tx")

        y0 = iy * bh - halo
        x0 = ix * bw - halo
        ys = y0 + jnp.arange(bh + 2 * halo)[:, None]
        ys_l = jnp.clip(ys, 0, h - 1) - y0

        def extend(img, x_lo):
            xs = x0 - (x_lo - halo) + jnp.arange(bw + halo + x_lo)[None, :]
            e = _halo_exchange(img, 0, "ty", halo, halo)
            e = _halo_exchange(e, 1, "tx", x_lo, halo)
            return e[ys_l, jnp.clip(xs, 0, w - 1) - (x0 - (x_lo - halo))]

        l_ext = extend(l_blk, halo)
        r_ext = extend(r_blk, halo + ctx)

        parts = compute_patch_parts(
            l_ext, r_ext, cfg_tile, x_offset=x0, image_width=w,
            right_context=ctx, own=(halo, halo + bw),
            y_offset=y0, image_height=h,
        )
        rows = slice(halo, halo + bh)
        qr = parts.qr[rows]                       # [bh, bw + 2*halo]
        spill = parts.spill[rows]                 # [bh, SP]
        sp = spill.shape[1]

        def from_prev(x):
            n = lax.axis_size("tx")
            r = lax.ppermute(x, "tx", [(i, i + 1) for i in range(n - 1)])
            return jnp.where(ix == 0, big, r)

        def from_next(x):
            n = lax.axis_size("tx")
            r = lax.ppermute(x, "tx", [(i + 1, i) for i in range(n - 1)])
            return jnp.where(ix == ntx - 1, big, r)

        # Assembled right-view packed-min map over positions
        # [ix*bw - reach, (ix+1)*bw)  (everything this tile's LR lookups
        # can touch), every frame column counted once by its owning tile.
        # k: positions below this tile's extended block, reachable only
        # through spills (empty when the warm-up halo already spans the
        # lookup reach).
        k = reach - halo
        nh = min(halo, bw + reach)  # next-head columns inside the map
        # Spill columns that can be non-BIG: positions below -SP have no
        # in-tile source (sources reach at most D-1 right of a position
        # and SP >= D), so when k > SP (large min_disparity vs halo) the
        # leading k - SP map columns are prev-tile-only and start BIG.
        ke = min(k, sp)
        prev_tail = from_prev(qr[:, halo + bw - reach : halo + bw])
        next_head = from_next(qr[:, halo - nh : halo])
        if k > 0:
            lead = (
                [jnp.full((qr.shape[0], k - ke), big, jnp.float32)]
                if k > ke
                else []
            )
            emap = jnp.concatenate(
                lead + [spill[:, sp - ke:], qr[:, : bw + halo]], axis=1
            )                                      # [bh, bw + reach]
            next_spill = from_next(spill[:, sp - ke:])
            emap = emap.at[:, bw + k - ke : bw + k].min(next_spill)
        else:
            emap = qr[:, -k : bw + halo]
        emap = emap.at[:, :reach].min(prev_tail)
        emap = emap.at[:, bw + reach - nh :].min(next_head)
        from ..ops.postprocess import (
            lr_gate_from_right_map,
            unpack_partial_min,
        )

        d_r = unpack_partial_min(emap, d).astype(jnp.int16)
        map_org = ix * bw - reach                  # global origin of emap

        crop = (rows, slice(halo, halo + bw))
        ok_nolr = parts.ok_nolr[crop]
        lr_bit = parts.lr_bit[crop]
        d0 = parts.d0[crop]
        disp_c = parts.disp[crop]

        def regate(lo, hi):
            # x_offset and r_offset are traced (device-index algebra) but
            # their difference is the static lo + reach — pass it so the
            # per-plane map shift lowers to slices, not a gather.
            return lr_gate_from_right_map(
                d0[:, lo:hi], d_r, cfg, x_offset=ix * bw + lo,
                image_width=w, r_offset=map_org, r_delta=lo + reach,
            ).astype(jnp.int32)

        if bw <= 2 * reach:
            gate = regate(0, bw)
        else:
            gate = jnp.concatenate(
                [regate(0, reach), lr_bit[:, reach : bw - reach],
                 regate(bw - reach, bw)], axis=1,
            )
        ys_o = iy * bh + jnp.arange(bh)[:, None]
        xs_o = ix * bw + jnp.arange(bw)[None, :]
        in_frame = (ys_o >= 0) & (ys_o < h) & (xs_o >= 0) & (xs_o < w)
        valid_c = ((ok_nolr & gate) > 0) & in_frame

        if cfg.median_filter:
            disp_c = _cropped_median(disp_c, iy, ix, bh, bw, h, w)

        return StereoResult(disp=disp_c, valid=valid_c)

    return tile_fn


def build_halo_pipeline(
    cfg: StereoConfig,
    mesh: Mesh,
    tile_cfg: Optional[TileConfig] = None,
    donate: bool = False,
    lr_stitch: Optional[bool] = None,
):
    """Jitted tiled ``(left, right) -> StereoResult`` over mesh ('ty','tx').

    Accepts any [H, W]; images are padded on-device to tile multiples and
    the padding is masked invalid and cropped from the output.

    ``lr_stitch`` (None = auto): the warm-up-only overlap regime
    (make_stitched_tile_fn) replaces the legacy halo + D x-halos where
    supported — same SGM-warm-up error model, ~2D fewer overlap columns
    per tile along 'tx'.
    """
    tile_cfg = tile_cfg or TileConfig(
        mesh_shape=(mesh.shape["ty"], mesh.shape["tx"])
    )
    ty, tx = mesh.shape["ty"], mesh.shape["tx"]
    halo_y, halo_x_lo, halo_x_hi = _halo_widths(cfg, tile_cfg)

    def tiled(left, right):
        h, w = left.shape
        hp, wp = padded_extent(h, ty), padded_extent(w, tx)
        bh, bw = hp // ty, wp // tx
        left_p = jnp.pad(left, ((0, hp - h), (0, wp - w)))
        right_p = jnp.pad(right, ((0, hp - h), (0, wp - w)))

        trivial = ty == 1 and tx == 1 and (hp, wp) == (h, w)
        halo = tile_cfg.resolved_halo(cfg)
        stitch = lr_stitch
        if stitch is None:
            stitch = (
                tx > 1 and stitch_supported(cfg, bw, halo) and not trivial
            )
        elif stitch and (trivial or not stitch_supported(cfg, bw, halo)):
            raise ValueError(
                "lr_stitch needs a non-trivial tile grid, the cheap-LR "
                "re-index (lr_check without lr_exact), SGM paths, a "
                "census/rank cost, tiles at least D + min_disparity "
                "wide, and a halo covering the descriptor window radius"
            )
        if stitch:
            tile_fn = make_stitched_tile_fn(cfg, h, w, bh, bw, halo)
        else:
            tile_fn = make_tile_fn(
                cfg, h, w, bh, bw, halo_y, halo_x_lo, halo_x_hi,
                trivial=trivial,
            )
        res = shard_map(
            tile_fn,
            mesh=mesh,
            in_specs=(P("ty", "tx"), P("ty", "tx")),
            out_specs=StereoResult(disp=P("ty", "tx"), valid=P("ty", "tx")),
            # The SGM kernel's pallas_call (a trivial tile is a whole
            # frame) carries no varying-mesh-axes metadata; out_specs
            # above already pin the output layout.
            check_vma=False,
        )(left_p, right_p)
        return StereoResult(disp=res.disp[:h, :w], valid=res.valid[:h, :w])

    out_sharding = StereoResult(
        disp=NamedSharding(mesh, P()), valid=NamedSharding(mesh, P())
    )
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(
        tiled, out_shardings=out_sharding, donate_argnums=donate_argnums
    )
