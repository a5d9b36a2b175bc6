"""Two-process localhost distributed run (DCN-path plumbing, SURVEY.md §4.3).

Spawns two Python processes that meet at a localhost coordinator, form one
8-device mesh (4 fake CPU devices each), run the exact-mode pipeline, and
must produce output identical to the single-process golden pipeline.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_exact_pipeline(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multiprocess worker timed out")
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"

    from stereo_tpu import StereoConfig, compute_disparity
    from stereo_tpu.data import make_pair

    pair = make_pair((48, 64), max_disp=8, kind="shapes", seed=7)
    cfg = StereoConfig(num_disparities=8, num_paths=4, subpixel=False)
    golden = np.array(compute_disparity(pair.left, pair.right, cfg).disp)
    got = np.load(tmp_path / "mp_disp.npy")
    np.testing.assert_array_equal(got, golden)


def _run_stream_workers(tmp_path, run_id, fail_after):
    worker = os.path.join(os.path.dirname(__file__), "mp_stream_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port),
             str(tmp_path), str(run_id), str(fail_after)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("stream worker timed out")
        outs.append(out.decode(errors="replace"))
    return procs, outs


def test_two_process_stream_kill_and_restart(tmp_path):
    """SURVEY.md §5 failure detection: the 2-process
    stream checkpoints, one worker is killed mid-stream (fault injection
    after 8 of 12 frames; process 1 os._exits with no cleanup), both
    restart from their manifests and finish — every frame processed
    exactly once across runs/processes, outputs bit-identical to the
    single-process pipeline."""
    import json

    # run 1: fault after 8 frames — both processes die (SPMD jobs die as
    # a unit). Process 1 hard-exits; process 0 records its progress and
    # exits — either via its own sys.exit(3) or, if the coordination
    # service's failure detector fires first (heartbeat timeout on the
    # dead peer during the shutdown barrier), via the JAX distributed
    # runtime's fatal termination. Both are "the survivor died because
    # the peer was killed"; what matters is nonzero exit + saved state.
    procs, outs = _run_stream_workers(tmp_path, run_id=1, fail_after=8)
    assert procs[0].returncode != 0, outs[0][-2000:]
    assert "died after fault injection" in outs[0], outs[0][-2000:]
    assert procs[1].returncode == 1, outs[1][-2000:]
    for pid in range(2):
        with open(tmp_path / f"manifest_p{pid}.json") as f:
            assert json.load(f)["frames_done"] == 8

    # run 2: clean restart, resume from the manifest cursor
    procs, outs = _run_stream_workers(tmp_path, run_id=2, fail_after="none")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert "frames=12" in out
    for pid in range(2):
        with open(tmp_path / f"manifest_p{pid}.json") as f:
            assert json.load(f)["frames_done"] == 12

    # exactly-once accounting across runs and processes
    all_ids = []
    for run_id in (1, 2):
        for pid in range(2):
            with open(tmp_path / f"ids_run{run_id}_p{pid}.json") as f:
                all_ids.extend(json.load(f))
    assert sorted(all_ids) == list(range(12)), sorted(all_ids)

    # outputs match the single-process pipeline bit-for-bit
    from stereo_tpu import StereoConfig, compute_disparity
    from stereo_tpu.data import make_pair

    cfg = StereoConfig(num_disparities=8, num_paths=4, subpixel=False)
    for run_id in (1, 2):
        for pid in range(2):
            z = np.load(tmp_path / f"disp_run{run_id}_p{pid}.npz")
            for fid in z.files:
                pair = make_pair((48, 64), max_disp=6, kind="shapes",
                                 seed=int(fid))
                golden = np.array(
                    compute_disparity(pair.left, pair.right, cfg).disp
                )
                np.testing.assert_array_equal(z[fid], golden, err_msg=fid)
