#!/usr/bin/env python
"""On-card smoke test: the stereo pipeline on NVIDIA GPUs, end to end.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py           # one card: phases 1-4
    python chip_smoke.py --multi   # four cards: the multi-card paths only

Phases (one card):
  1. setup: card name and power limit (nvidia-smi), JAX version, device
     kind, compile-cache directory, whether the C++ speckle filter loaded;
     the KITTI preset compiled ahead of time with its memory analysis.
  2. the Triton SGM kernel against the golden ``lax.scan`` on the card at
     full width (KITTI D=128 fixed and adaptive P2, Middlebury half-res
     D=64 4-path, D=16, SAD), exact; and once against the golden scan on
     the host CPU on a crop.
  3. the main path: ``build_pipeline(KITTI_SGM8_128)`` on 8 synthetic
     375x1242 pairs, each through block_until_ready, device_get and
     host_postprocess; integer winners and the valid mask bit-identical to
     backend="jnp" on the card, subpixel disparity within DISP_ATOL, and
     clean-pair quality (bad-3 < 0.02, density > 0.95).
  4. the other entry points at full width, each against backend="jnp":
     tsukuba_sad16, middlebury_census_sgm4_64, kitti_sgm8_128_quality,
     exact LR, the pyramid model, middlebury_full_256_tiled through
     build_banded_pipeline, StreamRunner on a one-card mesh, and the CLI.

``--multi`` (four cards) runs the batched StreamRunner, the exact reshard
and 2x2 halo tiles at KITTI width and compares each with the one-card
output. The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed; any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

KITTI = (375, 1242)

#: Subpixel disparity tolerance (pixels) between the kernel and golden
#: pipelines. Their integer inputs are bit-identical; the f32 parabola fit
#: runs in two separately compiled XLA programs whose fusions may contract
#: or reorder it differently, which moves the last bits of values < 256.
DISP_ATOL = 1e-4


def exact(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.sum(got != want)) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: {bad} elements differ ({got.shape})")


def close(name, got, want, atol=DISP_ATOL):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if got.shape != want.shape or not err <= atol:
        raise AssertionError(f"{name}: max |diff| {err} > {atol}")
    return err


def same_result(name, got, want):
    """valid bit-identical, disp within DISP_ATOL; returns max |diff|."""
    exact(f"{name} valid", got.valid, want.valid)
    return close(f"{name} disp", got.disp, want.disp)


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception:  # a failed phase is reported, the rest still run
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name}: FAILED", flush=True)
            return
        print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_setup(ctx):
    import jax

    from stereo_tpu import KITTI_SGM8_128, build_pipeline, native
    from stereo_tpu.data import make_pair

    print("jax", jax.__version__, "| device_kind", jax.devices()[0].device_kind,
          "| devices", len(jax.devices()))
    print("compile cache:", ctx["cache"])
    print("speckle filter:", "C++ (native)" if native.load() else "Python fallback")
    pair = make_pair(KITTI, max_disp=96, texture="cloud", seed=0)
    t0 = time.perf_counter()
    compiled = build_pipeline(KITTI_SGM8_128).lower(pair.left, pair.right).compile()
    print(f"KITTI 375x1242 D=128 compiled in {time.perf_counter() - t0:.1f} s")
    print("memory_analysis:", compiled.memory_analysis())


def phase_kernel(ctx):
    import jax
    import jax.numpy as jnp

    from stereo_tpu import PRESETS
    from stereo_tpu.data import make_pair
    from stereo_tpu.ops import cost_volume, sgm_aggregate
    from stereo_tpu.ops.pallas.sgm_kernel import sgm_aggregate_pallas

    kitti = PRESETS["kitti_sgm8_128"]
    cases = [
        ("KITTI D=128 8-path fixed P2", KITTI, kitti),
        ("KITTI D=128 8-path adaptive P2", KITTI, PRESETS["kitti_sgm8_128_quality"]),
        ("Middlebury 555x900 D=64 4-path", (555, 900),
         PRESETS["middlebury_census_sgm4_64"]),
        ("KITTI D=16 8-path", KITTI, kitti.replace(num_disparities=16)),
        ("Tsukuba 288x384 SAD D=16 8-path", (288, 384),
         PRESETS["tsukuba_sad16"].replace(num_paths=8)),
    ]
    for name, shape, cfg in cases:
        pair = make_pair(shape, max_disp=cfg.num_disparities * 3 // 4,
                         texture="cloud", seed=1)
        vol = jax.jit(lambda l, r, c=cfg: cost_volume(l, r, c))(pair.left, pair.right)
        img = jnp.asarray(pair.left)
        got = jax.jit(lambda v, i, c=cfg: sgm_aggregate_pallas(v, c, image=i))(vol, img)
        want = jax.jit(lambda v, i, c=cfg: sgm_aggregate(v, c, image=i))(vol, img)
        exact(name, got, want)
        print(f"  {name}: S bit-identical {tuple(got.shape)}")

    # The card against the host CPU, on a crop.
    cfg = kitti.replace(num_disparities=32, adaptive_p2=True, adaptive_grad_floor=12)
    pair = make_pair((64, 128), max_disp=24, texture="cloud", seed=2)
    vol = cost_volume(jnp.asarray(pair.left), jnp.asarray(pair.right), cfg)
    got = sgm_aggregate_pallas(vol, cfg, image=jnp.asarray(pair.left))
    cpu = jax.devices("cpu")[0]
    want = jax.jit(lambda v, i: sgm_aggregate(v, cfg, image=i))(
        jax.device_put(vol, cpu), jax.device_put(pair.left, cpu)
    )
    exact("GPU kernel vs CPU golden 64x128 D=32", got, want)
    print("  GPU kernel vs CPU golden 64x128 D=32: S bit-identical")


def _winners(cfg):
    import jax

    from stereo_tpu.ops import cost_volume
    from stereo_tpu.ops.wta import wta_with_aux
    from stereo_tpu.pipeline.pipeline import aggregate

    return jax.jit(
        lambda l, r: wta_with_aux(aggregate(cost_volume(l, r, cfg), cfg, image=l), cfg)[2]
    )


def phase_main_path(ctx):
    import jax

    from stereo_tpu import KITTI_SGM8_128, build_pipeline
    from stereo_tpu.data import make_pair
    from stereo_tpu.eval import evaluate_disparity
    from stereo_tpu.pipeline.pipeline import host_postprocess

    cfg = KITTI_SGM8_128
    fn, fn_g = build_pipeline(cfg), build_pipeline(cfg.replace(backend="jnp"))
    win, win_g = _winners(cfg), _winners(cfg.replace(backend="jnp"))
    times, worst = [], 0.0
    for i in range(8):
        pair = make_pair(KITTI, max_disp=96, texture="cloud", seed=i)
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(pair.left, pair.right))
        disp, valid = jax.device_get((res.disp, res.valid))
        disp, valid = host_postprocess(disp, valid, cfg)
        times.append(time.perf_counter() - t0)
        want = fn_g(pair.left, pair.right)
        worst = max(worst, same_result(f"frame {i}", res, want))
        exact(f"frame {i} integer winners", win(pair.left, pair.right),
              win_g(pair.left, pair.right))
        m = evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)
        if not (m["bad3"] < 0.02 and m["density"] > 0.95):
            raise AssertionError(f"frame {i} quality {m}")
        print(f"  frame {i}: {times[-1] * 1e3:.2f} ms (device + host post), "
              f"bad3 {m['bad3']:.4f} density {m['density']:.4f}")
    print(f"  per-frame ms on {ctx['card']}: "
          + " ".join(f"{t * 1e3:.2f}" for t in times)
          + f" (frame 0 includes compilation); max |disp diff| {worst:g}")


def phase_entry_points(ctx):
    import jax
    from jax.sharding import Mesh

    from stereo_tpu import PRESETS, build_pipeline
    from stereo_tpu.data import make_pair
    from stereo_tpu.models import get_model
    from stereo_tpu.parallel import StreamRunner, build_banded_pipeline

    def both(make, cfg):
        return make(cfg), make(cfg.replace(backend="jnp"))

    runs = [
        ("tsukuba_sad16 288x384", (288, 384), PRESETS["tsukuba_sad16"], build_pipeline),
        ("middlebury_census_sgm4_64 555x900", (555, 900),
         PRESETS["middlebury_census_sgm4_64"], build_pipeline),
        ("kitti_sgm8_128_quality", KITTI, PRESETS["kitti_sgm8_128_quality"], build_pipeline),
        ("kitti_sgm8_128 lr_exact", KITTI,
         PRESETS["kitti_sgm8_128"].replace(lr_exact=True), build_pipeline),
        ("pyramid model KITTI", KITTI, PRESETS["kitti_sgm8_128"],
         lambda c: get_model("pyramid", cfg=c).build()),
    ]
    for name, shape, cfg, make in runs:
        pair = make_pair(shape, max_disp=min(96, cfg.num_disparities * 3 // 4),
                         texture="cloud", seed=3)
        fk, fg = both(make, cfg)
        err = same_result(name, fk(pair.left, pair.right), fg(pair.left, pair.right))
        print(f"  {name}: valid bit-identical, max |disp diff| {err:g}")

    # Middlebury full resolution: the whole frame on one card (its compiled
    # memory is printed), and 4 row bands against the golden scan (whose
    # per-direction scan buffers make a whole-frame golden run too large).
    cfg = PRESETS["middlebury_full_256_tiled"]
    pair = make_pair((1988, 2880), max_disp=200, texture="cloud", seed=4)
    shape = pair.left.shape
    whole = build_banded_pipeline(cfg, shape, n_bands=1)
    compiled = whole.lower(pair.left, pair.right).compile()
    print("  middlebury_full_256 whole frame memory_analysis:",
          compiled.memory_analysis())
    res = jax.block_until_ready(whole(pair.left, pair.right))
    dens = float(np.mean(np.asarray(res.valid)))
    if not (np.all(np.isfinite(np.asarray(res.disp))) and dens > 0.5):
        raise AssertionError(f"middlebury_full_256 whole frame density {dens}")
    fk, fg = both(lambda c: build_banded_pipeline(c, shape, n_bands=4), cfg)
    err = same_result("middlebury_full_256 4 bands",
                      fk(pair.left, pair.right), fg(pair.left, pair.right))
    print(f"  middlebury_full_256 4 bands: valid bit-identical, max |disp diff| {err:g}")

    # StreamRunner on a one-card mesh, 2 batches of 2 frames.
    cfg = PRESETS["kitti_sgm8_128"]
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), ("batch", "ty", "tx"))
    frames = [make_pair(KITTI, max_disp=96, texture="cloud", seed=10 + i)
              for i in range(4)]
    outs = []
    runner = StreamRunner(cfg, mesh, frames[0].left.shape, batch_size=2)
    runner.run([(p.left, p.right) for p in frames],
               on_result=lambda r: outs.append(jax.device_get(r)))
    golden = build_pipeline(cfg.replace(backend="jnp"))
    got = [(d, v) for r in outs for d, v in zip(r.disp, r.valid)]
    if len(got) != 4:
        raise AssertionError(f"stream returned {len(got)} frames")
    for i, (p, (d, v)) in enumerate(zip(frames, got)):
        want = golden(p.left, p.right)
        exact(f"stream frame {i} valid", v, want.valid)
        close(f"stream frame {i} disp", d, want.disp)
    print("  StreamRunner 1-card mesh, 2 batches: matches golden")

    from stereo_tpu.cli import main as cli_main

    rc = cli_main(["run", "--demo", "--demo-shape", "375", "1242",
                   "--preset", "kitti_sgm8_128"])
    if rc != 0:
        raise AssertionError(f"cli run --demo returned {rc}")
    print("  cli run --demo: ok")


def phase_multi(ctx):
    import jax

    from stereo_tpu import PRESETS, build_pipeline
    from stereo_tpu.data import make_pair
    from stereo_tpu.parallel import (
        StreamRunner,
        build_exact_pipeline,
        build_halo_pipeline,
        make_tile_mesh,
    )

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--multi needs 4 cards, found {len(devs)}")
    devs = devs[:4]
    cfg = PRESETS["kitti_sgm8_128"]
    one = build_pipeline(cfg)
    one_g = build_pipeline(cfg.replace(backend="jnp"))
    frames = [make_pair(KITTI, max_disp=96, texture="cloud", seed=20 + i)
              for i in range(8)]

    mesh_b = make_tile_mesh(devs, mesh_shape=(1, 1), batch=4)
    outs = []
    runner = StreamRunner(cfg, mesh_b, frames[0].left.shape, batch_size=4)
    t0 = time.perf_counter()
    stats = runner.run([(p.left, p.right) for p in frames],
                       on_result=lambda r: outs.append(jax.device_get(r)))
    print(f"  StreamRunner batch=4 on 4 cards: {stats['frames']} frames in "
          f"{time.perf_counter() - t0:.2f} s (incl. compilation)")
    got = [(d, v) for r in outs for d, v in zip(r.disp, r.valid)]
    for i, (p, (d, v)) in enumerate(zip(frames, got)):
        want = one(p.left, p.right)
        exact(f"stream frame {i} valid", v, want.valid)
        exact(f"stream frame {i} disp", d, want.disp)
    if len(got) != 8:
        raise AssertionError(f"stream returned {len(got)} frames")
    print("  StreamRunner batch=4: bit-identical to one card")

    pair = frames[0]
    mesh_t = make_tile_mesh(devs, mesh_shape=(2, 2))
    ex = build_exact_pipeline(cfg, mesh_t)(pair.left, pair.right)
    want = one_g(pair.left, pair.right)
    exact("exact reshard valid", ex.valid, want.valid)
    exact("exact reshard disp", ex.disp, want.disp)
    print("  exact reshard 2x2: bit-identical to the one-card golden pipeline")

    res = build_halo_pipeline(cfg, mesh_t)(pair.left, pair.right)
    ref = one(pair.left, pair.right)
    d, g = np.asarray(res.disp), np.asarray(ref.disp)
    both = np.asarray(res.valid) & np.asarray(ref.valid)
    mismatch = float((np.abs(d - g) > 1)[both].mean())
    vdiff = float((np.asarray(res.valid) != np.asarray(ref.valid)).mean())
    print(f"  halo tiles 2x2: |diff| > 1 px on {mismatch:.4%} of pixels, "
          f"valid differs on {vdiff:.4%}")
    if not (mismatch < 0.02 and vdiff < 0.02):
        raise AssertionError("halo tiles outside the tested 2% bound")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: stream, exact reshard and halo tiles only")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    from stereo_tpu.utils.card import card
    from stereo_tpu.utils.compile_cache import enable_compile_cache

    ctx = {"card": card(), "cache": enable_compile_cache()}
    print("card:", ctx["card"], flush=True)
    phases = Phases()
    if args.multi:
        phases.run("multi-card paths vs one card", phase_multi, ctx)
    else:
        phases.run("1 setup and AOT compile", phase_setup, ctx)
        phases.run("2 SGM kernel vs golden scan", phase_kernel, ctx)
        phases.run("3 main path, 8 KITTI frames", phase_main_path, ctx)
        phases.run("4 other entry points", phase_entry_points, ctx)
    if phases.failed:
        print("FAILED phases:", ", ".join(phases.failed), flush=True)
        return 1
    dev = jax.devices()[0]
    print("card:", ctx["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
