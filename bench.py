#!/usr/bin/env python
"""Benchmark harness. Prints ONE JSON line on stdout (driver contract).

Headline metric (BASELINE.json:2,5): frames/sec/chip at KITTI-resolution
(375 x 1242) 128-disparity 8-path SGM with subpixel + LR-check.
vs_baseline is fps / 60 — the driver-set >=60 fps/chip target (the
reference publishes no numbers of its own, BASELINE.json:13).

Detailed per-stage and per-config results are appended to
bench_results/results.jsonl; stdout carries only the single JSON line. Every
record names the card and its power limit (nvidia-smi). A full run needs a
GPU and fails without one; ``--quick`` is a CPU smoke test at toy shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from stereo_tpu.utils.card import card

TARGET_FPS = 60.0


def _git_sha() -> str:
    """Short HEAD sha, with a '-dirty' marker when CODE differs from HEAD.

    Result logs (bench_results/) churn on every run and are excluded —
    the marker records whether the benchmarked code is the committed code.
    """
    cwd = os.path.dirname(__file__) or "."
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, cwd=cwd,
        ).stdout.strip()
        if not sha:
            return "unknown"
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--",
             ":(exclude)bench_results"],
            capture_output=True, text=True, cwd=cwd,
        ).stdout.strip()
        return sha + ("-dirty" if dirty else "")
    except Exception:
        return "unknown"


def time_fn(fn, args, warmup=2, iters=10, min_time=2.0):
    """Device seconds per call via chained in-jit iterations
    (stereo_tpu/utils/timing.py)."""
    from stereo_tpu.utils.timing import chained_seconds_per_call

    sec = chained_seconds_per_call(fn, args, iters=iters)
    return sec, [sec] * iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small shapes on CPU (smoke test)")
    ap.add_argument("--preset", default="kitti_sgm8_128")
    ap.add_argument("--iters", type=int, default=40,
                    help="chained in-jit iterations per repeat")
    ap.add_argument("--all", action="store_true",
                    help="also bench secondary configs/models to results.jsonl")
    args = ap.parse_args()

    if args.quick:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )

    import jax

    if args.quick:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX runs on {jax.default_backend()!r}"
            " (use --quick for the CPU smoke test)"
        )
    from stereo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card_name = card()

    from stereo_tpu import PRESETS, build_pipeline
    from stereo_tpu.data import make_pair
    from stereo_tpu.eval import evaluate_disparity

    cfg = PRESETS[args.preset]
    if args.quick:
        shape, max_disp = (96, 160), 12
        cfg = cfg.replace(num_disparities=16)
    else:
        shape, max_disp = (375, 1242), 96  # KITTI 2015 resolution

    pair = make_pair(shape, max_disp=max_disp, kind="shapes",
                     texture="cloud", seed=0)
    fn = build_pipeline(cfg)

    sec, times = time_fn(fn, (pair.left, pair.right), iters=args.iters)
    fps = 1.0 / sec

    res = fn(pair.left, pair.right)
    quality = evaluate_disparity(
        np.asarray(res.disp), pair.gt_disp, pair.gt_valid,
        np.asarray(res.valid),
    )

    device = str(jax.devices()[0])
    record = {
        "metric": f"{args.preset}_fps_" + ("cpu_smoke" if args.quick else "per_chip"),
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / TARGET_FPS, 4),
        "config": args.preset,
        "shape": list(shape),
        "num_disparities": cfg.num_disparities,
        "num_paths": cfg.num_paths,
        "sec_per_frame": round(sec, 6),
        "bad3": round(quality["bad3"], 5),
        "epe": round(quality["epe"], 5),
        "density": round(quality["density"], 5),
        "device": device,
        "card": card_name,
        "backend": jax.default_backend(),
        "git_sha": _git_sha(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "n_timed": len(times),
    }

    out_dir = os.path.join(os.path.dirname(__file__) or ".", "bench_results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")

    # FULL-RES hard-suite rows for BOTH presets: the
    # quality axis measured at the same resolution the fps metric quotes
    # (every pre-r5 hard_suite row was at 160x288 while the headline is
    # defined at 375x1242 — and the speckle knob provably does not
    # transfer across that scale, docs/tuning.md; presets now ship
    # speckle_rel). One seed here keeps the driver bench bounded; the
    # 3-seed sweeps live in --all / bench_results.
    hard_worst = {}
    for preset_name in ("kitti_sgm8_128", "kitti_sgm8_128_quality"):
        cfg_p = PRESETS[preset_name]
        if args.quick:
            cfg_p = cfg_p.replace(num_disparities=16)
        rows = _hard_suite_rows(
            jax, out_dir, record["git_sha"], cfg_p, preset_name,
            shape=shape, seeds=(0,), tag="full_res",
        )
        hard_worst[preset_name] = max(r["bad3_noc"] for r in rows)

    if args.all:
        _bench_secondary(jax, out_dir, record["git_sha"], quick=args.quick)

    # Driver contract: exactly one JSON line on stdout. The line carries
    # BOTH north-star axes: fps vs the 60-fps bar, and
    # the worst full-res hard-suite bad3 per preset vs the <=4% bar.
    print(json.dumps({
        "metric": record["metric"],
        "value": record["value"],
        "unit": "fps",
        "vs_baseline": record["vs_baseline"],
        "full_res_bad3_worst": round(hard_worst["kitti_sgm8_128"], 5),
        "full_res_bad3_worst_quality_preset": round(
            hard_worst["kitti_sgm8_128_quality"], 5
        ),
        "card": card_name,
    }))
    return 0


def _hard_suite_rows(jax, out_dir, sha, cfg, preset_name, shape, seeds, tag):
    """Run the hard suite for one config; append tagged rows; return them."""
    from stereo_tpu.eval.hard_suite import run_hard_suite

    rows = run_hard_suite(cfg, shape=shape, seeds=seeds)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
    dev = str(jax.devices()[0])
    with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
        for r in rows:
            rec = {
                "metric": f"hard_suite_{r['scenario']}_bad3",
                "value": r["bad3_noc"], "unit": "fraction",
                **r, "shape": list(shape), "preset": preset_name,
                "tag": tag, "num_disparities": cfg.num_disparities,
                "device": dev, "card": card(), "git_sha": sha,
                "timestamp": stamp,
            }
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), file=sys.stderr)
    return rows


def _bench_secondary(jax, out_dir, sha, quick=False):
    """Configs 1/2 + model families; appended to results.jsonl (stderr log)."""
    import numpy as np

    from stereo_tpu import PRESETS
    from stereo_tpu.data import make_pair
    from stereo_tpu.eval import evaluate_disparity
    from stereo_tpu.models import get_model
    from stereo_tpu.utils.timing import chained_seconds_per_call

    # Config 4 first: the full-res 2880x1988 x 256 frame on one card, whole
    # frame (parallel/bands.py with one band); its compiled memory is
    # recorded in PERF.md.
    from stereo_tpu.parallel import build_banded_pipeline

    shape4 = (96, 160) if quick else (1988, 2880)
    cfg4 = PRESETS["middlebury_full_256_tiled"]
    if quick:
        cfg4 = cfg4.replace(num_disparities=16)
    pair4 = make_pair(shape4, max_disp=12 if quick else 200, kind="shapes",
                      texture="cloud", seed=0)
    fn4 = build_banded_pipeline(
        cfg4, shape4, n_bands=2 if quick else 1, n_cols=1
    )
    sec4 = chained_seconds_per_call(
        lambda l, r: fn4(l, r), (pair4.left, pair4.right), iters=15
    )
    res4 = fn4(pair4.left, pair4.right)
    q4 = evaluate_disparity(
        np.asarray(res4.disp), pair4.gt_disp, pair4.gt_valid,
        np.asarray(res4.valid),
    )
    rec4 = {
        "metric": "middlebury_full_256_patched_fps_per_chip",
        "value": round(1.0 / sec4, 3),
        "unit": "fps",
        "shape": list(shape4),
        "num_disparities": cfg4.num_disparities,
        "num_paths": cfg4.num_paths,
        "sec_per_frame": round(sec4, 6),
        "bad3": round(q4["bad3"], 5),
        "epe": round(q4["epe"], 5),
        "density": round(q4["density"], 5),
        "device": str(jax.devices()[0]),
        "card": card(),
        "git_sha": sha,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "note": "single-card whole frame",
    }
    with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
        f.write(json.dumps(rec4) + "\n")
    print(json.dumps(rec4), file=sys.stderr)

    # Single-card batched-stream throughput (P1 on one device): each chunk
    # of frames runs through an in-jit lax.scan; the runner's completion
    # proof fetches one element per shard before the clock stops.
    from jax.sharding import Mesh

    from stereo_tpu.parallel import StreamRunner

    shape_s = (96, 160) if quick else (375, 1242)
    cfg_s = PRESETS["kitti_sgm8_128"]
    if quick:
        cfg_s = cfg_s.replace(num_disparities=16)
    # One jit call processes `batch` frames via in-chunk lax.scan.
    batch, n_frames = (2, 8) if quick else (48, 96)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("batch", "ty", "tx"))
    runner = StreamRunner(cfg_s, mesh, shape_s, batch_size=batch)
    # Pre-stage stacked chunks on device: the measurement targets the
    # engine's sustained rate, not host-to-device upload.
    frames = [
        make_pair(shape_s, max_disp=12 if quick else 96, kind="shapes",
                  texture="cloud", seed=i)
        for i in range(n_frames)
    ]
    batches = [
        (
            jax.device_put(np.stack([p.left for p in frames[i:i + batch]])),
            jax.device_put(np.stack([p.right for p in frames[i:i + batch]])),
        )
        for i in range(0, n_frames, batch)
    ]
    runner.run_batches(batches[:1], on_result=lambda r: None)  # warm compile
    runner.frames_done, runner.elapsed = 0, 0.0
    stats = runner.run_batches(batches)
    rec_s = {
        "metric": f"kitti_stream_batch{batch}_fps_per_chip",
        "value": round(stats["fps"], 3),
        "unit": "fps",
        "shape": list(shape_s),
        "batch": batch,
        "frames": stats["frames"],
        "device": str(jax.devices()[0]),
        "card": card(),
        "git_sha": sha,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "note": "single-chip DP throughput (scan chunks, async overlap)",
    }
    with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
        f.write(json.dumps(rec_s) + "\n")
    print(json.dumps(rec_s), file=sys.stderr)

    runs = [
        ("tsukuba_sad16", "classic", (288, 384), 14, {}, ""),
        ("middlebury_census_sgm4_64", "classic", (555, 900), 48, {}, ""),
        # the pyramid is the speed-trade model: it opts into the 1-word
        # 5x5 descriptor explicitly (PyramidSGM inherits cfg's window by
        # default since r5)
        ("kitti_sgm8_128", "pyramid", (375, 1242), 96, {}, ""),
        # the tuned quality preset (adaptive P2 + gradient noise floor,
        # docs/tuning.md): the config that clears every hard-suite bar
        ("kitti_sgm8_128_quality", "classic", (375, 1242), 96, {}, ""),
        # exact-LR: full flipped-pair second pass — the cost of
        # exactness over the cheap re-index the headline config uses
        ("kitti_sgm8_128", "classic", (375, 1242), 96,
         {"lr_exact": True}, "+lr_exact"),
    ]
    if quick:
        runs = [(p_, m_, (96, 160), 12,
                 {"num_disparities": 16, **o_}, s_)
                for (p_, m_, _, _, o_, s_) in runs]
    for preset, model_name, shape, max_disp, overrides, suffix in runs:
        cfg = PRESETS[preset].replace(**overrides) if overrides else PRESETS[preset]
        pair = make_pair(shape, max_disp=max_disp, kind="shapes",
                         texture="cloud", seed=0)
        mkw = {"census_window": (5, 5)} if model_name == "pyramid" else {}
        model = get_model(model_name, cfg=cfg, **mkw)
        fn = model.build()
        sec = chained_seconds_per_call(
            lambda l, r: fn(l, r), (pair.left, pair.right), iters=30
        )
        res = fn(pair.left, pair.right)
        q = evaluate_disparity(
            np.asarray(res.disp), pair.gt_disp, pair.gt_valid,
            np.asarray(res.valid),
        )
        rec = {
            "metric": f"{preset}+{model_name}{suffix}_fps_per_chip",
            "value": round(1.0 / sec, 3),
            "unit": "fps",
            "shape": list(shape),
            "sec_per_frame": round(sec, 6),
            "bad3": round(q["bad3"], 5),
            "epe": round(q["epe"], 5),
            "density": round(q["density"], 5),
            "device": str(jax.devices()[0]),
            "card": card(),
        "card": card(),
            "git_sha": sha,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), file=sys.stderr)

    # Hard synthetic suite (eval/hard_suite.py): the quality numbers that
    # back the README table — adversarial scenarios, not the easy clean
    # pairs. One compile covers all scenarios (same
    # shape). BOTH presets sweep at suite scale AND full KITTI res,
    # 3 seeds each.
    from stereo_tpu.eval.hard_suite import census_vs_sad_robustness

    shape_h, seeds_h = ((96, 160), (0,)) if quick else ((160, 288), (0, 1, 2))
    shape_f = (96, 160) if quick else (375, 1242)
    for preset_name in ("kitti_sgm8_128", "kitti_sgm8_128_quality"):
        cfg_p = PRESETS[preset_name]
        if quick:
            cfg_p = cfg_p.replace(num_disparities=16)
        _hard_suite_rows(jax, out_dir, sha, cfg_p, preset_name,
                         shape=shape_h, seeds=seeds_h, tag="suite_scale")
        _hard_suite_rows(jax, out_dir, sha, cfg_p, preset_name,
                         shape=shape_f, seeds=seeds_h, tag="full_res")

    cfg_h = PRESETS["kitti_sgm8_128"]
    if quick:
        cfg_h = cfg_h.replace(num_disparities=16)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
    dev = str(jax.devices()[0])
    with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
        cmp_rows = census_vs_sad_robustness(
            cfg_h, shape=shape_h, seeds=seeds_h[:1]
        )
        rec = {
            "metric": "census_vs_sad_radiometric_bad3",
            "value": cmp_rows["census"]["bad3_noc"], "unit": "fraction",
            "census": cmp_rows["census"], "sad": cmp_rows["sad"],
            "shape": list(shape_h), "device": dev, "card": card(),
            "git_sha": sha,
            "timestamp": stamp,
            "note": "census invariance vs SAD collapse under per-view "
                    "gain/bias/gamma (SURVEY.md C2)",
        }
        f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
