"""Command-line interface (SURVEY.md L6).

Reference analog: main.cpp arg parsing + image load + timing printout
(SURVEY.md §1.1 L4). Subcommands:

  info    devices / presets
  run     one rectified pair (files or --demo synthetic) -> disparity maps
  eval    dataset sweep with metrics + resume (Middlebury/KITTI/synthetic)
  stream  batched video-stream throughput run (config 5)
  bench   timed single-config benchmark (same engine as bench.py)

Config fields are overridable per-run with --set key=value (the runtime
equivalent of the reference's compile-time #defines, SURVEY.md §5).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from .config import PRESETS, StereoConfig


def _apply_overrides(cfg: StereoConfig, sets) -> StereoConfig:
    fields = {f.name: f for f in dataclasses.fields(StereoConfig)}
    kw = {}
    for s in sets or []:
        if "=" not in s:
            raise SystemExit(f"--set expects key=value, got {s!r}")
        k, v = s.split("=", 1)
        if k not in fields:
            raise SystemExit(
                f"unknown config field {k!r}; valid: {sorted(fields)}"
            )
        t = fields[k].type
        if t in ("int", int):
            kw[k] = int(v)
        elif t in ("float", float):
            kw[k] = float(v)
        elif t in ("bool", bool):
            kw[k] = v.lower() in ("1", "true", "yes", "on")
        elif "Tuple" in str(t):
            kw[k] = tuple(int(x) for x in v.split(","))
        else:
            kw[k] = v
    return cfg.replace(**kw) if kw else cfg


def _cfg_from_args(args) -> StereoConfig:
    cfg = PRESETS.get(args.preset)
    if cfg is None:
        raise SystemExit(f"unknown preset {args.preset!r}; valid: {sorted(PRESETS)}")
    return _apply_overrides(cfg, getattr(args, "set", None))


def _load_pair(args):
    from .data.synthetic import make_pair

    if args.demo:
        return make_pair(
            tuple(args.demo_shape), max_disp=args.demo_max_disp,
            kind="shapes", texture="cloud", seed=args.seed,
        )
    if args.scene:
        from .data.middlebury import load_scene

        return load_scene(args.scene)
    if not (args.left and args.right):
        raise SystemExit("need --left/--right, --scene, or --demo")
    from .data.middlebury import load_image_gray
    from .data.synthetic import StereoPair

    left = load_image_gray(args.left)
    right = load_image_gray(args.right)
    gt = np.zeros(left.shape, np.float32)
    gtv = np.zeros(left.shape, bool)
    if args.gt:
        if args.gt.endswith(".pfm"):
            from .data.middlebury import read_pfm

            gt = read_pfm(args.gt)
            gtv = np.isfinite(gt) & (gt > 0)
        else:
            from .data.kitti import read_kitti_disparity

            gt, gtv = read_kitti_disparity(args.gt)
    name = os.path.splitext(os.path.basename(args.left))[0]
    return StereoPair(left, right, gt, gtv, name=name)


def cmd_info(args) -> int:
    import jax

    print(f"backend: {jax.default_backend()}")
    print(f"devices: {[str(d) for d in jax.devices()]}")
    print("presets:")
    for name, cfg in PRESETS.items():
        print(
            f"  {name:28s} cost={cfg.cost_fn:6s} D={cfg.num_disparities:3d} "
            f"paths={cfg.num_paths} subpix={int(cfg.subpixel)} "
            f"lr={int(cfg.lr_check)}"
        )
    return 0


def cmd_run(args) -> int:
    import jax

    from .eval.metrics import evaluate_disparity
    from .pipeline.pipeline import build_pipeline

    cfg = _cfg_from_args(args)
    pair = _load_pair(args)

    if args.tiles:
        from .parallel import build_halo_pipeline, make_tile_mesh

        ty, tx = (int(v) for v in args.tiles.split(","))
        mesh = make_tile_mesh(jax.devices()[: ty * tx], mesh_shape=(ty, tx))
        fn = build_halo_pipeline(cfg, mesh)
    elif args.exact_mesh:
        from .parallel import build_exact_pipeline, make_tile_mesh

        ty, tx = (int(v) for v in args.exact_mesh.split(","))
        mesh = make_tile_mesh(jax.devices()[: ty * tx], mesh_shape=(ty, tx))
        fn = build_exact_pipeline(cfg, mesh, dplane_cost=args.dplane_cost)
    elif args.model != "classic":
        from .models import get_model

        fn = get_model(args.model, cfg=cfg).build()
    else:
        fn = build_pipeline(cfg)

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        jax.block_until_ready(fn(pair.left, pair.right))  # compile outside
        with jax.profiler.trace(args.profile):
            res = fn(pair.left, pair.right)
            jax.block_until_ready(res.disp)
        print(f"profile trace written to {args.profile}", file=sys.stderr)
    else:
        t0 = time.perf_counter()
        res = fn(pair.left, pair.right)
        jax.block_until_ready(res.disp)
        compile_s = time.perf_counter() - t0
        # Chained timing: the device's steady-state time per frame
        # (utils/timing.py).
        from .utils.timing import chained_seconds_per_call

        steady = chained_seconds_per_call(
            lambda l, r: fn(l, r), (pair.left, pair.right), iters=5,
            repeats=1,
        )
        print(
            f"[{pair.name}] compile+run {compile_s:.2f}s, "
            f"steady-state {steady:.4f}s ({1.0/steady:.1f} fps)",
            file=sys.stderr,
        )

    if args.dump_volume:
        # Kernel-debugging aid (SURVEY.md §5 checkpoint/resume: optional
        # cost-volume dump): the aggregated volume from the golden path.
        from .ops import cost_volume, sgm_aggregate

        vol = cost_volume(pair.left, pair.right, cfg)
        s_vol = sgm_aggregate(vol, cfg, image=pair.left)
        np.save(args.dump_volume, np.asarray(s_vol))
        print(f"wrote {args.dump_volume}", file=sys.stderr)

    from .pipeline.pipeline import host_postprocess

    disp, valid = host_postprocess(res.disp, res.valid, cfg)
    if pair.gt_valid.any():
        m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
        print(json.dumps({"pair": pair.name, **{k: round(v, 5) for k, v in m.items()}}))

    rig = None
    if args.rig:
        from .utils.depth import CameraRig

        parts = [float(v) for v in args.rig.split(",")]
        if len(parts) < 2:
            raise SystemExit("--rig expects fx,baseline[,doffs]")
        rig = CameraRig(parts[0], parts[1],
                        parts[2] if len(parts) > 2 else 0.0)
    elif args.calib:
        from .utils.depth import parse_middlebury_calib

        rig = parse_middlebury_calib(args.calib)
    elif args.scene and (args.depth_out or args.ply):
        calib = os.path.join(args.scene, "calib.txt")
        if os.path.exists(calib):
            from .utils.depth import parse_middlebury_calib

            rig = parse_middlebury_calib(calib)
    if (args.depth_out or args.ply) and rig is None:
        raise SystemExit(
            "--depth-out/--ply need rig intrinsics: --rig fx,baseline[,doffs]"
            " or --calib calib.txt (auto-discovered beside --scene)"
        )
    if args.depth_out:
        from .utils.depth import disparity_to_depth

        depth = np.asarray(disparity_to_depth(disp, valid, rig))
        np.save(args.depth_out, depth)
        print(f"wrote {args.depth_out}", file=sys.stderr)
    if args.ply:
        from .utils.depth import reproject, write_ply

        pts = reproject(disp, valid, rig)
        n = write_ply(args.ply, pts, valid, colors=pair.left)
        print(f"wrote {args.ply} ({n} points)", file=sys.stderr)

    if args.out:
        from .utils.viz import colorize_disparity, save_png

        base, ext = os.path.splitext(args.out)
        if ext == ".pfm":
            from .data.middlebury import write_pfm

            write_pfm(args.out, np.where(valid, disp, np.inf))
        elif ext == ".png" and args.kitti_format:
            from .data.kitti import write_kitti_disparity

            write_kitti_disparity(args.out, disp, valid)
        else:
            save_png(args.out, colorize_disparity(disp, valid))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_eval(args) -> int:
    from .eval.harness import EvalHarness

    cfg = _cfg_from_args(args)

    if args.hard_suite:
        # Adversarial synthetic sweep (eval/hard_suite.py): radiometric
        # distortion, occlusions, textureless regions, slanted planes,
        # thin structures, rectification jitter.
        from .eval.hard_suite import run_hard_suite

        rows = run_hard_suite(
            cfg,
            shape=tuple(args.demo_shape),
            seeds=tuple(range(args.limit or 3)),
            model=args.model,
        )
        for r in rows:
            print(json.dumps(r))
            if args.results:
                with open(args.results, "a") as f:
                    f.write(json.dumps({"metric": "hard_suite", **r}) + "\n")
        return 0

    def pairs():
        if args.middlebury:
            from .data.middlebury import discover_scenes, load_scene

            for d in discover_scenes(args.middlebury):
                yield load_scene(d)
        elif args.kitti:
            from .data.kitti import list_frame_ids, load_kitti_pair

            ids = list_frame_ids(args.kitti)[: args.limit or None]
            for fid in ids:
                yield load_kitti_pair(args.kitti, fid)
        else:
            from .data.synthetic import make_pair

            n = args.limit or 8
            max_disp = max(4, cfg.num_disparities * 3 // 4)
            for i in range(n):
                yield make_pair(
                    (192, 320), max_disp=max_disp, kind="shapes",
                    texture="cloud", seed=i,
                )

    harness = EvalHarness(
        cfg,
        results_path=args.results,
        manifest_path=args.manifest,
        artifacts_dir=args.artifacts,
        model=args.model,
    )
    summary = harness.run(pairs())
    print(json.dumps(summary))
    return 0


def cmd_stream(args) -> int:
    import jax

    from .parallel import StreamRunner, make_tile_mesh

    cfg = _cfg_from_args(args)
    n = len(jax.devices())
    batch = args.batch_axis
    tiles = n // batch
    ty, tx = (int(v) for v in args.tiles.split(",")) if args.tiles else (tiles, 1)
    mesh = make_tile_mesh(
        jax.devices()[: batch * ty * tx], mesh_shape=(ty, tx), batch=batch
    )

    if args.kitti:
        from .data.kitti import frame_pairs

        frames = list(frame_pairs(args.kitti, limit=args.limit))
        shape = frames[0][0].shape
    else:
        from .data.synthetic import make_pair

        nf = args.limit or 32
        shape = tuple(args.demo_shape)
        max_disp = max(4, cfg.num_disparities * 3 // 4)
        frames = [
            (p.left, p.right)
            for p in (
                make_pair(shape, max_disp=max_disp, kind="shapes",
                          texture="cloud", seed=i)
                for i in range(nf)
            )
        ]

    runner = StreamRunner(
        cfg, mesh, shape, batch_size=args.batch, manifest_path=args.manifest
    )
    stats = runner.run(frames)
    print(json.dumps(stats))
    return 0


def cmd_scale(args) -> int:
    import json as _json

    from .eval.scaling import scaling_report

    cfg = _cfg_from_args(args)
    counts = (
        [int(v) for v in args.devices.split(",")] if args.devices else None
    )
    ty, tx = (
        (int(v) for v in args.tiles.split(",")) if args.tiles else (1, 1)
    )
    rows = scaling_report(
        cfg,
        image_shape=tuple(args.demo_shape),
        device_counts=counts,
        tiles_per_device=(ty, tx) if args.tiles else (1, 1),
        iters=args.iters,
    )
    for r in rows:
        print(_json.dumps(r))
    return 0


def cmd_bench(args) -> int:
    from .data.synthetic import make_pair
    from .pipeline.pipeline import build_pipeline
    from .utils.timing import chained_seconds_per_call

    cfg = _cfg_from_args(args)
    pair = make_pair(
        tuple(args.demo_shape), max_disp=args.demo_max_disp,
        kind="shapes", texture="cloud", seed=0,
    )
    fn = build_pipeline(cfg)
    sec = chained_seconds_per_call(
        lambda l, r: fn(l, r), (pair.left, pair.right), iters=args.iters
    )
    print(json.dumps({
        "preset": args.preset, "shape": list(pair.left.shape),
        "sec_per_frame": round(sec, 6), "fps": round(1.0 / sec, 2),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stereo-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--preset", default="kitti_sgm8_128")
        p.add_argument("--set", action="append", metavar="KEY=VALUE")
        p.add_argument("--model", default="classic",
                       choices=["classic", "block_matching", "pyramid"])

    p = sub.add_parser("info")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("run")
    add_common(p)
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--gt")
    p.add_argument("--scene", help="Middlebury scene directory")
    p.add_argument("--demo", action="store_true", help="synthetic pair")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--demo-max-disp", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help=".png (colormap), .pfm, or KITTI .png")
    p.add_argument("--kitti-format", action="store_true")
    p.add_argument("--tiles", help="halo-tiled run over ty,tx devices")
    p.add_argument("--exact-mesh", help="exact reshard mode over ty,tx")
    p.add_argument("--dplane-cost", action="store_true",
                   help="with --exact-mesh: build the cost volume "
                        "disparity-plane-sharded (P3) before the reshard")
    p.add_argument("--rig", metavar="FX,BASELINE[,DOFFS]",
                   help="rig intrinsics for depth/point-cloud export")
    p.add_argument("--calib", help="Middlebury calib.txt path")
    p.add_argument("--depth-out", metavar="NPY",
                   help="save metric depth (Z = f*B/(d+doffs)) as .npy")
    p.add_argument("--ply", metavar="PLY",
                   help="export the valid pixels as a 3-D point cloud")
    p.add_argument("--profile", help="dump a jax.profiler trace directory")
    p.add_argument("--dump-volume", metavar="NPY",
                   help="save the aggregated cost volume (debug, golden path)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("eval")
    add_common(p)
    p.add_argument("--middlebury", help="root of Middlebury scene dirs")
    p.add_argument("--kitti", help="KITTI 2015 training root")
    p.add_argument("--hard-suite", action="store_true",
                   help="adversarial synthetic sweep (radiometric/"
                        "occlusion/textureless/slant/thin/jitter)")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(160, 288),
                   help="pair shape for --hard-suite")
    p.add_argument("--limit", type=int)
    p.add_argument("--results", help="append JSONL records here")
    p.add_argument("--manifest", help="resume manifest path")
    p.add_argument("--artifacts", help="write disparity/error PNGs here")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("stream")
    add_common(p)
    p.add_argument("--kitti", help="KITTI root for real frames")
    p.add_argument("--limit", type=int)
    p.add_argument("--batch", type=int, help="frames per step")
    p.add_argument("--batch-axis", type=int, default=1,
                   help="size of the 'batch' mesh axis")
    p.add_argument("--tiles", help="ty,tx tile mesh per frame")
    p.add_argument("--manifest", help="stream resume manifest")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("scale")
    add_common(p)
    p.add_argument("--devices", help="comma list of device counts")
    p.add_argument("--tiles", help="ty,tx tiles per frame")
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(fn=cmd_scale)

    p = sub.add_parser("bench")
    add_common(p)
    p.add_argument("--demo-shape", type=int, nargs=2, default=(375, 1242))
    p.add_argument("--demo-max-disp", type=int, default=96)
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    ap.add_argument("--log", default=None, help="log level (DEBUG/INFO/...)")
    args, _ = ap.parse_known_args(argv)
    from .utils.compile_cache import enable_compile_cache
    from .utils.log import setup

    setup(args.log)
    enable_compile_cache()
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
