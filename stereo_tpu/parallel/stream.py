"""Batched video-stream runner: data parallel + tile parallel + pipelining.

Reference behavior: none — the reference processes one pair per run
(SURVEY.md §3.1); multi-frame throughput is new scope (BASELINE.json:11,
config 5: batched KITTI video stream, multi-host tile-parallel SGM).

Design (SURVEY.md §2.2 P1 + P4, §3.4):
  * frames shard over the 'batch' mesh axis (P1), tiles over ('ty','tx');
  * stage pipelining (P4) comes from JAX async dispatch: the host enqueues
    batch n+1 while batch n computes, with donated I/O buffers so XLA
    reuses the frame memory;
  * the runner checkpoints stream position to a JSON manifest and resumes
    from it (SURVEY.md §5 "checkpoint/resume": there are no weights — the
    checkpoint is the frame cursor + accumulated stats).
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import StereoConfig, TileConfig
from ..pipeline.pipeline import StereoResult
from .tiling import (
    _halo_widths,
    make_stitched_tile_fn,
    make_tile_fn,
    padded_extent,
    shard_map,
    stitch_supported,
)


def build_stream_pipeline(
    cfg: StereoConfig,
    mesh: Mesh,
    image_shape: Tuple[int, int],
    tile_cfg: Optional[TileConfig] = None,
    donate: bool = False,
    lr_stitch: Optional[bool] = None,
):
    """Jitted ``(left [B,H,W], right [B,H,W]) -> StereoResult [B,H,W]``.

    ``donate`` is off by default: uint8 frame buffers cannot alias the f32
    disparity outputs, so donation would only emit warnings.

    B must be a multiple of the 'batch' mesh axis. Frames split over
    'batch'; each device runs its frame chunk SEQUENTIALLY via lax.scan
    (each frame tiles over ('ty','tx') exactly like the single-pair halo
    pipeline). scan, not vmap: one frame's volumes are live at a time
    (vmap multiplied every [H,W,D] intermediate by the local batch) and
    each scan step keeps the kernels' single-frame shapes, while one
    dispatch covers the whole chunk. Outputs stay sharded over 'batch'
    (each host keeps its frames).
    """
    tile_cfg = tile_cfg or TileConfig(
        mesh_shape=(mesh.shape["ty"], mesh.shape["tx"])
    )
    ty, tx = mesh.shape["ty"], mesh.shape["tx"]
    h, w = image_shape
    hp, wp = padded_extent(h, ty), padded_extent(w, tx)
    bh, bw = hp // ty, wp // tx
    halo_y, halo_x_lo, halo_x_hi = _halo_widths(cfg, tile_cfg)
    halo = tile_cfg.resolved_halo(cfg)
    trivial = ty == 1 and tx == 1 and (hp, wp) == (h, w)
    stitch = lr_stitch
    if stitch is None:
        stitch = not trivial and tx > 1 and stitch_supported(cfg, bw, halo)
    elif stitch and (trivial or not stitch_supported(cfg, bw, halo)):
        raise ValueError(
            "lr_stitch needs a non-trivial tile grid with tx > 1, the "
            "cheap-LR re-index, SGM paths, a census/rank cost, tiles "
            "at least D + min_disparity wide, and a halo covering the "
            "descriptor window radius"
        )
    if stitch:
        # Warm-up-only x-overlap + cross-tile LR stitching (see
        # tiling.make_stitched_tile_fn) — same error model, ~2D fewer
        # overlap columns per tile along 'tx'.
        tile_fn = make_stitched_tile_fn(cfg, h, w, bh, bw, halo)
    else:
        tile_fn = make_tile_fn(
            cfg, h, w, bh, bw, halo_y, halo_x_lo, halo_x_hi,
            trivial=trivial,
        )

    def batched(left, right):
        if left.shape[1:] != (h, w):
            raise ValueError(
                f"stream pipeline built for {h}x{w} frames, got {left.shape}"
            )
        lp = jnp.pad(left, ((0, 0), (0, hp - h), (0, wp - w)))
        rp = jnp.pad(right, ((0, 0), (0, hp - h), (0, wp - w)))

        def per_chunk(l_loc, r_loc):
            def step(_, lr):
                return None, tile_fn(lr[0], lr[1])

            _, out = jax.lax.scan(step, None, (l_loc, r_loc))
            return out

        res = shard_map(
            per_chunk,
            mesh=mesh,
            in_specs=(P("batch", "ty", "tx"), P("batch", "ty", "tx")),
            out_specs=StereoResult(
                disp=P("batch", "ty", "tx"), valid=P("batch", "ty", "tx")
            ),
            # The SGM kernel's pallas_call (a trivial tile is a whole
            # frame) carries no varying-mesh-axes metadata; out_specs
            # above already pin the output layout.
            check_vma=False,
        )(lp, rp)
        return StereoResult(
            disp=res.disp[:, :h, :w], valid=res.valid[:, :h, :w]
        )

    out_sharding = StereoResult(
        disp=NamedSharding(mesh, P("batch")),
        valid=NamedSharding(mesh, P("batch")),
    )
    donate_argnums = (0, 1) if donate else ()
    return jax.jit(
        batched, out_shardings=out_sharding, donate_argnums=donate_argnums
    )


class StreamRunner:
    """Drives a frame stream through the batched pipeline with resume.

    Reference analog: none (single pair per process). The manifest file
    records the next frame index and accumulated timing so an interrupted
    run restarts where it left off (SURVEY.md §5 failure/checkpoint notes).
    """

    def __init__(
        self,
        cfg: StereoConfig,
        mesh: Mesh,
        image_shape: Tuple[int, int],
        batch_size: Optional[int] = None,
        tile_cfg: Optional[TileConfig] = None,
        manifest_path: Optional[str] = None,
        lr_stitch: Optional[bool] = None,
        max_in_flight: int = 2,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.image_shape = image_shape
        self.batch = batch_size or mesh.shape["batch"]
        # Batches kept in flight before draining (P4 pipelining depth):
        # the host enqueues the next batch while the device computes.
        self.max_in_flight = max(1, int(max_in_flight))
        if self.batch % mesh.shape["batch"]:
            raise ValueError("batch_size must divide the 'batch' mesh axis")
        self.manifest_path = manifest_path
        self.pipeline = build_stream_pipeline(
            cfg, mesh, image_shape, tile_cfg, lr_stitch=lr_stitch
        )
        self.frames_done = 0
        self.elapsed = 0.0
        if manifest_path and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                m = json.load(f)
            self.frames_done = int(m.get("frames_done", 0))
            self.elapsed = float(m.get("elapsed", 0.0))

    def _checkpoint(self) -> None:
        if not self.manifest_path:
            return
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"frames_done": self.frames_done, "elapsed": self.elapsed}, f
            )
        os.replace(tmp, self.manifest_path)

    @staticmethod
    def _completion_proof(arr) -> None:
        """Tiny d2h fetch from EVERY addressable shard of ``arr``.

        Fetching one element of arr[-1] only synchronizes the device
        holding the last batch shard — with the 'batch' mesh axis spanning
        devices, other devices could still be computing when elapsed is
        recorded. One corner element per shard is a round trip to each
        device that cannot return before its shard exists.
        """
        for s in arr.addressable_shards:
            np.asarray(s.data[(-1,) * s.data.ndim])

    def run_batches(
        self,
        batches: Iterable[Tuple[jnp.ndarray, jnp.ndarray]],
        on_result=None,
        checkpoint_every: int = 64,
    ) -> dict:
        """Process pre-stacked ``(left [B,H,W], right [B,H,W])`` batches.

        The zero-copy path for producers that already hold device-resident
        stacked chunks (e.g. a decoder writing straight into a device ring):
        skips run()'s per-frame accumulation and on-device stacking.
        Resume bookkeeping matches run(): batches fully
        covered by the manifest cursor are skipped, progress checkpoints
        every ``checkpoint_every`` frames, and a cursor that does not fall
        on a batch boundary is rejected (stacked batches cannot be split).
        """
        pending = []

        def drain_one():
            res, n_real = pending.pop(0)
            self._completion_proof(res.disp)
            if on_result is not None:
                on_result(res)
            self.frames_done += n_real

        to_skip = self.frames_done
        n_this_run = 0
        last_ckpt = 0
        # Timer starts at the first PROCESSED batch: producing
        # already-checkpointed batches during resume is not engine time
        # (round-3 review).
        t0 = None
        for left, right in batches:
            if left.shape[0] != self.batch:
                raise ValueError(
                    f"batch extent {left.shape[0]} != runner batch {self.batch}"
                )
            if to_skip >= left.shape[0]:
                to_skip -= left.shape[0]
                continue
            if t0 is None:
                t0 = time.perf_counter()
            if to_skip:
                raise ValueError(
                    f"manifest cursor {self.frames_done} does not align to "
                    f"the {self.batch}-frame batch boundary; resume "
                    "run_batches() with the same batch size it was "
                    "checkpointed with"
                )
            pending.append((self.pipeline(left, right), left.shape[0]))
            n_this_run += left.shape[0]
            while len(pending) > self.max_in_flight:
                drain_one()
            # >=, not modulo: batch sizes that don't divide
            # checkpoint_every would otherwise postpone the first
            # checkpoint to lcm(batch, checkpoint_every) frames.
            if checkpoint_every and n_this_run - last_ckpt >= checkpoint_every:
                last_ckpt = n_this_run
                while pending:
                    drain_one()
                self.elapsed += time.perf_counter() - t0
                t0 = time.perf_counter()
                self._checkpoint()
        while pending:
            drain_one()
        if t0 is not None:
            self.elapsed += time.perf_counter() - t0
        self._checkpoint()
        fps = self.frames_done / self.elapsed if self.elapsed else 0.0
        return {
            "frames": self.frames_done,
            "elapsed": self.elapsed,
            "fps": fps,
        }

    def run(
        self,
        frames: Iterable[Tuple[np.ndarray, np.ndarray]],
        on_result=None,
        checkpoint_every: int = 8,
        fail_after: Optional[int] = None,
    ) -> dict:
        """Process (left, right) frame pairs; returns throughput stats.

        ``on_result`` receives DEVICE-resident arrays (sliced to the real
        frame count); call np.asarray on what you need — the runner never
        pulls whole batches to the host itself.

        Frames before the manifest cursor are skipped (resume). Partial
        trailing batches are padded with the last frame and the padding
        results dropped. ``fail_after`` raises after N frames — the fault
        injection hook used by the restart test (SURVEY.md §5).
        """
        it = iter(frames)
        skipped = 0
        while skipped < self.frames_done:
            next(it)
            skipped += 1

        batch_l, batch_r = [], []
        pending = []  # (result, n_real) for async-dispatch overlap (P4)

        def drain_one():
            res, n_real = pending.pop(0)
            # Completion proof: one corner element from every addressable
            # shard (_completion_proof) — a real d2h round trip per device
            # that cannot return before the batch's output exists. Results
            # stay ON DEVICE; consumers np.asarray what they need.
            self._completion_proof(res.disp)
            if on_result is not None:
                on_result(
                    StereoResult(
                        disp=res.disp[:n_real], valid=res.valid[:n_real]
                    )
                )
            self.frames_done += n_real

        def flush(n_real):
            pad = [batch_l[-1]] * (self.batch - n_real)
            # Device-resident frames stack ON DEVICE (np.stack would pull
            # them back to host): callers may pre-stage frames with
            # jax.device_put so the stream measures the engine, not the
            # host-to-device upload.
            stack = jnp.stack if isinstance(batch_l[0], jax.Array) else np.stack
            l = stack(batch_l + pad)
            r = stack(batch_r + [batch_r[-1]] * (self.batch - n_real))
            res = self.pipeline(l, r)
            pending.append((res, n_real))
            # Keep at most two batches in flight: the host stays ahead of
            # the device (P4 overlap) without unbounded queueing.
            while len(pending) > self.max_in_flight:
                drain_one()

        t0 = time.perf_counter()
        n_this_run = 0
        last_ckpt = 0
        for left, right in it:
            batch_l.append(left)
            batch_r.append(right)
            if len(batch_l) == self.batch:
                flush(self.batch)
                batch_l, batch_r = [], []
                n_this_run += self.batch
                if fail_after is not None and n_this_run >= fail_after:
                    while pending:
                        drain_one()
                    self.elapsed += time.perf_counter() - t0
                    self._checkpoint()
                    raise RuntimeError(
                        f"fault injection: failing after {n_this_run} frames"
                    )
                # cadence-based (not modulo): 0 disables, and batch sizes
                # that don't divide checkpoint_every still checkpoint on
                # schedule (round-3 review).
                if (checkpoint_every
                        and n_this_run - last_ckpt >= checkpoint_every):
                    last_ckpt = n_this_run
                    while pending:
                        drain_one()
                    self.elapsed += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    self._checkpoint()
        if batch_l:
            flush(len(batch_l))
        while pending:
            drain_one()
        if t0 is not None:
            self.elapsed += time.perf_counter() - t0
        self._checkpoint()
        fps = self.frames_done / self.elapsed if self.elapsed else 0.0
        return {
            "frames": self.frames_done,
            "elapsed": self.elapsed,
            "fps": fps,
        }
