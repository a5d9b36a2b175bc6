"""Batched stream runner tests: correctness, resume, fault injection."""

import numpy as np
import pytest

import jax

from stereo_tpu import StereoConfig, compute_disparity
from stereo_tpu.data import make_pair
from stereo_tpu.parallel import (
    StreamRunner,
    build_stream_pipeline,
    make_tile_mesh,
)


@pytest.fixture(scope="module")
def mesh_b2():
    return make_tile_mesh(jax.devices()[:8], mesh_shape=(2, 2), batch=2)


CFG = StereoConfig(
    cost_fn="census", num_disparities=8, num_paths=0, subpixel=False,
    median_filter=False,
)
SHAPE = (32, 48)


def _frames(n, seed=0):
    return [
        (p.left, p.right)
        for p in (
            make_pair(SHAPE, max_disp=6, kind="constant", seed=seed + i)
            for i in range(n)
        )
    ]


def test_stream_matches_per_frame(mesh_b2):
    frames = _frames(4)
    fn = build_stream_pipeline(CFG, mesh_b2, SHAPE, donate=False)
    l = np.stack([f[0] for f in frames])
    r = np.stack([f[1] for f in frames])
    # batch 4 over batch-axis 2: reshape into two device groups of 2 each
    res = fn(l[:2], r[:2])
    for i in range(2):
        g = compute_disparity(frames[i][0], frames[i][1], CFG)
        np.testing.assert_array_equal(np.array(res.disp[i]), np.array(g.disp))


def test_stream_scan_matches_tiled_sgm(mesh_b2):
    """The in-chunk lax.scan layout must be bit-identical per frame to the
    single-frame halo pipeline — full SGM + subpixel + LR, so any scan/vmap
    or buffer-reuse drift in the Pallas path shows up here."""
    from stereo_tpu.parallel import build_halo_pipeline

    cfg = StereoConfig(
        cost_fn="census", num_disparities=16, num_paths=8,
        subpixel=True, lr_check=True,
    )
    shape = (64, 96)
    frames = [
        make_pair(shape, max_disp=12, kind="shapes", seed=i) for i in range(4)
    ]
    runner = StreamRunner(cfg, mesh_b2, shape, batch_size=4)
    outs = []
    runner.run([(p.left, p.right) for p in frames],
               on_result=lambda r: outs.append(r))
    disp = np.concatenate([np.asarray(o.disp) for o in outs], axis=0)
    tiled = build_halo_pipeline(
        cfg, make_tile_mesh(jax.devices()[:4], mesh_shape=(2, 2))
    )
    for i in range(4):
        g = tiled(frames[i].left, frames[i].right)
        np.testing.assert_array_equal(disp[i], np.asarray(g.disp))


def test_runner_processes_all_frames(tmp_path, mesh_b2):
    frames = _frames(7)
    runner = StreamRunner(
        CFG, mesh_b2, SHAPE, batch_size=2,
        manifest_path=str(tmp_path / "m.json"),
    )
    outs = []
    stats = runner.run(frames, on_result=lambda r: outs.append(r))
    assert stats["frames"] == 7
    assert sum(o.disp.shape[0] for o in outs) == 7
    # last (padded) batch result matches golden
    g = compute_disparity(frames[6][0], frames[6][1], CFG)
    np.testing.assert_array_equal(np.array(outs[-1].disp[-1]), np.array(g.disp))


def test_run_batches_resume_skips_cursor(tmp_path, mesh_b2):
    """run_batches honors the manifest cursor (advisor r2): a resumed
    runner skips already-done batches instead of double-counting them."""
    frames = _frames(8, seed=50)
    batches = [
        (np.stack([f[0] for f in frames[i : i + 2]]),
         np.stack([f[1] for f in frames[i : i + 2]]))
        for i in range(0, 8, 2)
    ]
    manifest = str(tmp_path / "m.json")
    r1 = StreamRunner(CFG, mesh_b2, SHAPE, batch_size=2, manifest_path=manifest)
    r1.run_batches(batches[:2], checkpoint_every=2)
    assert r1.frames_done == 4

    outs = []
    r2 = StreamRunner(CFG, mesh_b2, SHAPE, batch_size=2, manifest_path=manifest)
    assert r2.frames_done == 4
    stats = r2.run_batches(batches, on_result=lambda r: outs.append(r))
    assert stats["frames"] == 8
    # only the two remaining batches were processed
    assert len(outs) == 2
    g = compute_disparity(frames[6][0], frames[6][1], CFG)
    np.testing.assert_array_equal(np.array(outs[-1].disp[0]), np.array(g.disp))

    # a cursor off the batch boundary is rejected, not double-counted
    r3 = StreamRunner(CFG, mesh_b2, SHAPE, batch_size=2, manifest_path=manifest)
    r3.frames_done = 3
    with pytest.raises(ValueError, match="align"):
        r3.run_batches(batches)


def test_stream_mesh_scale_combined(tmp_path, mesh_b2):
    """Config-5 CI scenario: batch axis + 2x2 tiles +
    fault injection + device-resident run_batches in one run, asserting
    bit-identity with the single-frame pipeline and resume accounting."""
    cfg = StereoConfig(
        cost_fn="census", num_disparities=16, num_paths=8,
        subpixel=True, lr_check=True,
    )
    shape = (48, 64)
    frames = [
        make_pair(shape, max_disp=12, kind="shapes", seed=200 + i)
        for i in range(8)
    ]
    batches = [
        (
            jax.device_put(np.stack([p.left for p in frames[i : i + 2]])),
            jax.device_put(np.stack([p.right for p in frames[i : i + 2]])),
        )
        for i in range(0, 8, 2)
    ]
    manifest = str(tmp_path / "m.json")

    class Boom(Exception):
        pass

    def fail_third(res):
        outs.append(res)
        if len(outs) == 2:
            raise Boom()

    outs = []
    r1 = StreamRunner(cfg, mesh_b2, shape, batch_size=2, manifest_path=manifest)
    with pytest.raises(Boom):
        r1.run_batches(batches, on_result=fail_third, checkpoint_every=2)
    # the crash struck after the checkpoint at frame 4 was cut or before;
    # the manifest must not claim MORE than was delivered
    import json

    with open(manifest) as f:
        done_at_crash = json.load(f)["frames_done"]
    assert done_at_crash <= 4

    r2 = StreamRunner(cfg, mesh_b2, shape, batch_size=2, manifest_path=manifest)
    outs2 = []
    stats = r2.run_batches(batches, on_result=lambda r: outs2.append(r))
    assert stats["frames"] == 8
    # the resumed runner starts at the checkpoint cursor: it redelivers
    # exactly the frames past it (at-least-once semantics)
    assert len(outs2) == (8 - done_at_crash) // 2
    # bit-identity of the batched scan path vs the single-frame halo
    # pipeline on the same 2x2 tile grid (halo tiling itself is bounded-
    # error vs untiled by design; the exact mode is parallel/exact.py)
    from stereo_tpu.parallel import build_halo_pipeline

    tiled = build_halo_pipeline(
        cfg, make_tile_mesh(jax.devices()[:4], mesh_shape=(2, 2))
    )
    last = np.asarray(outs2[-1].disp)
    for j, p in enumerate(frames[6:8]):
        g = tiled(p.left, p.right)
        np.testing.assert_array_equal(last[j], np.array(g.disp))


def test_runner_fault_inject_and_resume(tmp_path, mesh_b2):
    """Kill mid-stream, restart from manifest, end with every frame done
    exactly once (SURVEY.md §5 failure detection / restart-from-frame)."""
    frames = _frames(8, seed=100)
    manifest = str(tmp_path / "m.json")
    done = []

    r1 = StreamRunner(CFG, mesh_b2, SHAPE, batch_size=2, manifest_path=manifest)
    with pytest.raises(RuntimeError, match="fault injection"):
        r1.run(frames, on_result=lambda r: done.append(r.disp.shape[0]),
               fail_after=4, checkpoint_every=2)
    assert sum(done) == 4

    r2 = StreamRunner(CFG, mesh_b2, SHAPE, batch_size=2, manifest_path=manifest)
    assert r2.frames_done == 4
    stats = r2.run(frames, on_result=lambda r: done.append(r.disp.shape[0]))
    assert stats["frames"] == 8
    assert sum(done) == 8


def test_run_batches_checkpoint_cadence(tmp_path, mesh_b2):
    """Regression (round-3 review): checkpoint_every fired only when the
    frame count hit an exact multiple, so batch sizes that don't divide it
    postponed the first checkpoint to lcm(batch, checkpoint_every)."""
    from stereo_tpu.parallel.stream import StreamRunner

    manifest = str(tmp_path / "m.json")
    runner = StreamRunner(CFG, mesh_b2, SHAPE, batch_size=2,
                          manifest_path=manifest)
    ckpts = []
    orig = runner._checkpoint

    def spy():
        ckpts.append(runner.frames_done)
        orig()

    runner._checkpoint = spy
    frames = _frames(12, seed=51)
    batches = [
        (np.stack([f[0] for f in frames[i : i + 2]]),
         np.stack([f[1] for f in frames[i : i + 2]]))
        for i in range(0, 12, 2)
    ]
    runner.run_batches(batches, checkpoint_every=3)
    # 12 frames in 2-frame batches, cadence 3: checkpoints at >=4 and >=8
    # frames plus the final one — NOT only at the end.
    assert len(ckpts) >= 3, ckpts
    assert ckpts[0] <= 4, ckpts
