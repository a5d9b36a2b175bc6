#!/usr/bin/env python
"""End-to-end A/B of the SGM kernel against XLA's lax.scan on one GPU.

For each configuration, ``build_pipeline`` runs with backend="auto" (the
Triton SGM kernel) and backend="jnp" (the golden lax.scan) in alternating
rounds (kernel, scan, scan, kernel) in one process, and prints the median
per-frame latency (host clock around each call, which ends in
block_until_ready) with the card's name and power limit; then the same for
SGM aggregation alone on a precomputed cost volume. With --trace DIR
it also writes a profiler trace of a few kernel-path KITTI frames and prints
the device time per operation name.

    python tools/sgm_kernel_ab.py [--reps 10] [--trace chiprun_out/trace]
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = [
    ("KITTI 375x1242 D=128 8-path fixed P2", (375, 1242), "kitti_sgm8_128", {}),
    ("KITTI 375x1242 D=128 8-path adaptive P2", (375, 1242),
     "kitti_sgm8_128_quality", {}),
    ("Middlebury 555x900 D=64 4-path", (555, 900), "middlebury_census_sgm4_64", {}),
    ("KITTI 375x1242 D=16 8-path", (375, 1242), "kitti_sgm8_128",
     {"num_disparities": 16}),
]


def frame_ms(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))                          # compile, warm
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_ms_by_op(trace_dir):
    """Sum of device event durations per operation name in the trace."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    per_op = collections.Counter()
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per_op[ev.name] += ev.duration_ns / 1e6
    return per_op


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trace", help="profile 5 kernel-path KITTI frames here")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit("sgm_kernel_ab.py measures a GPU")
    from stereo_tpu import PRESETS, build_pipeline
    from stereo_tpu.data import make_pair
    from stereo_tpu.ops import cost_volume, sgm_aggregate
    from stereo_tpu.ops.pallas.sgm_kernel import sgm_aggregate_pallas
    from stereo_tpu.utils.card import card as card_label
    from stereo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_label()
    print(f"card: {card}", flush=True)
    for name, shape, preset, over in CONFIGS:
        cfg = PRESETS[preset].replace(**over)
        pair = make_pair(shape, max_disp=cfg.num_disparities * 3 // 4,
                         texture="cloud", seed=0)
        kern, scan = build_pipeline(cfg), build_pipeline(cfg.replace(backend="jnp"))
        k, s = [], []
        for fn, acc in ((kern, k), (scan, s), (scan, s), (kern, k)):
            acc += frame_ms(fn, (pair.left, pair.right), args.reps)
        print(f"{name}: kernel median {np.median(k):.3f} ms "
              f"(min {min(k):.3f}), lax.scan median {np.median(s):.3f} ms "
              f"(min {min(s):.3f}), {np.median(s) / np.median(k):.1f}x "
              f"[{card}]", flush=True)

        # SGM aggregation alone, on the same cost volume.
        vol = jax.jit(lambda l, r, c=cfg: cost_volume(l, r, c))(pair.left, pair.right)
        img = jax.numpy.asarray(pair.left)
        sgm_k = jax.jit(lambda v, i, c=cfg: sgm_aggregate_pallas(v, c, image=i))
        sgm_s = jax.jit(lambda v, i, c=cfg: sgm_aggregate(v, c, image=i))
        k, s = [], []
        for fn, acc in ((sgm_k, k), (sgm_s, s), (sgm_s, s), (sgm_k, k)):
            acc += frame_ms(fn, (vol, img), args.reps)
        print(f"  SGM alone: kernel median {np.median(k):.3f} ms, lax.scan "
              f"median {np.median(s):.3f} ms [{card}]", flush=True)

    if args.trace:
        cfg = PRESETS["kitti_sgm8_128"]
        pair = make_pair((375, 1242), max_disp=96, texture="cloud", seed=0)
        fn = build_pipeline(cfg)
        jax.block_until_ready(fn(pair.left, pair.right))
        with jax.profiler.trace(args.trace):
            for _ in range(5):
                jax.block_until_ready(fn(pair.left, pair.right))
        per_op = device_ms_by_op(args.trace)
        total = sum(per_op.values())
        print(f"device ms per KITTI frame by op (5 frames traced, {card}):")
        for op, ms in per_op.most_common(20):
            print(f"  {ms / 5:8.3f}  {100 * ms / total:5.1f}%  {op}")
        print(f"  {total / 5:8.3f}  total device time per frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
