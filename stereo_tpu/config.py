"""Static pipeline configuration.

The reference (Batshaw/Real-Time-Stereo-Matching-, an OpenCL C++ real-time
stereo matcher — see SURVEY.md §0: the mount was empty, so behavior is
reconstructed from BASELINE.json) configures its pipeline through CLI args and
compile-time ``#define``s (window size, disparity range, P1/P2), requiring a
rebuild per configuration (SURVEY.md §5 "Config / flag system").

The equivalent here is a frozen, hashable dataclass that is **static
under jit**: every field participates in the jit cache key, so each config
compiles to its own specialized XLA program — the same effect as the
reference's compile-time defines, without the manual rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Full static configuration of the stereo pipeline.

    Mirrors the reference capability surface (BASELINE.json:5): matching cost
    (census or SAD), cost-volume construction over ``num_disparities``, SGM
    path aggregation (0/4/8 paths), WTA selection, subpixel refinement,
    left-right consistency check, and median post-filter.
    """

    # --- matching cost -----------------------------------------------------
    cost_fn: str = "census"            # "census" (Hamming) | "sad" | "rank"
    census_window: Tuple[int, int] = (5, 5)   # (rows, cols); 5x5 -> 24-bit
    sad_window: Tuple[int, int] = (9, 9)      # block-matching window

    # --- cost volume -------------------------------------------------------
    num_disparities: int = 64          # D in {16, 64, 128, 256}
    min_disparity: int = 0

    # --- SGM aggregation ---------------------------------------------------
    num_paths: int = 8                 # 0 (plain WTA), 4 (HV), 8 (HV+diag)
    p1: int = 10                       # small-change penalty
    p2: int = 120                      # discontinuity penalty
    adaptive_p2: bool = False          # P2 / |dI| scaling (Hirschmueller '08)
    p2_min: int = 30                   # floor for adaptive P2
    adaptive_grad_floor: int = 0       # sensor-noise floor for adaptive P2:
    #                                    gradients <= floor count as flat
    #                                    (full P2). The classic P2/|dI|
    #                                    collapses smoothing in NOISY flat
    #                                    regions (sigma=6 noise -> |dI|~7 ->
    #                                    P2/7); measured on the hard suite
    #                                    (docs/tuning.md). 0 = classic.

    # --- selection / refinement -------------------------------------------
    subpixel: bool = True              # parabola fit around the WTA winner
    lr_check: bool = True              # left-right consistency
    lr_tau: float = 1.0                # max |d_L - d_R| allowed
    lr_exact: bool = False             # True: full 2nd pipeline pass for the
    #                                    right view; False: re-index the
    #                                    aggregated left volume (cheap)
    uniqueness_ratio: float = 0.0      # 0 disables; else best/second-best gate

    # --- post-filter -------------------------------------------------------
    median_filter: bool = True         # 3x3 median on the disparity map
    speckle_max_size: int = 0          # 0 disables speckle removal
    speckle_rel: float = 0.0           # resolution-relative speckle size:
    #                                    fraction of H*W; the effective
    #                                    size is max(speckle_max_size,
    #                                    round(speckle_rel * H * W)) —
    #                                    blob areas scale with resolution,
    #                                    so a fixed pixel count tuned at
    #                                    suite scale under-removes at
    #                                    full res (docs/tuning.md).
    speckle_tau: float = 2.0
    fill_occlusions: bool = False      # fill invalid pixels from row
    #                                    neighbors (Hirschmueller LR fill,
    #                                    native/; applied host-side)

    # --- numerics ----------------------------------------------------------
    cost_dtype: str = "int32"          # golden-path cost dtype
    backend: str = "auto"              # SGM implementation: "auto" (the
    #                                    Triton kernel on the GPU for
    #                                    unmasked calls, else the golden
    #                                    scan) | "jnp" (golden) | "pallas"
    #                                    (kernel, GPU only) |
    #                                    "pallas_interpret" (kernel in the
    #                                    Pallas interpreter — CPU tests)

    def __post_init__(self) -> None:
        if self.cost_fn not in ("census", "sad", "rank"):
            raise ValueError(
                f"cost_fn must be census|sad|rank, got {self.cost_fn}"
            )
        if self.num_paths not in (0, 4, 8):
            raise ValueError(f"num_paths must be 0|4|8, got {self.num_paths}")
        if self.backend not in ("auto", "jnp", "pallas", "pallas_interpret"):
            raise ValueError(
                "backend must be auto|jnp|pallas|pallas_interpret, got "
                f"{self.backend}"
            )
        if self.num_disparities < 1:
            raise ValueError("num_disparities must be >= 1")
        cw = self.census_window
        if cw[0] % 2 == 0 or cw[1] % 2 == 0:
            raise ValueError("census_window dims must be odd")
        if cw[0] * cw[1] - 1 > 64:
            raise ValueError("census descriptor limited to 64 bits")

    # number of 32-bit words needed to hold the census descriptor
    @property
    def census_words(self) -> int:
        bits = self.census_window[0] * self.census_window[1] - 1
        return (bits + 31) // 32

    @property
    def max_unary_cost(self) -> int:
        """Upper bound of the per-pixel matching cost (drives dtype choice)."""
        if self.cost_fn in ("census", "rank"):
            return self.census_window[0] * self.census_window[1] - 1
        # SAD of uint8 over the window, normalized by window size in ops.cost
        return 255

    @property
    def window_radius(self) -> int:
        """Descriptor/window support radius in pixels (max over y/x).

        Census and rank descriptors read ``census_window`` around each
        pixel; SAD reads ``sad_window``. Tile halos must cover at least
        this radius for border descriptors to be frame-true.
        """
        win = (
            self.census_window
            if self.cost_fn in ("census", "rank")
            else self.sad_window
        )
        return max(win[0] // 2, win[1] // 2)

    @property
    def cost_volume_dtype(self):
        """Narrowest exact dtype for the materialized cost volume.

        Census/rank costs are bounded by the window bit count (<= 63), so
        int8 is exact and halves the volume's HBM traffic through the four
        SGM passes; SAD costs reach 255 and stay int16. The SGM accumulator
        stays int16 regardless (8 paths * (max_unary_cost + P2) < 2^15).
        """
        import jax.numpy as jnp

        return jnp.int8 if self.max_unary_cost <= 127 else jnp.int16

    def replace(self, **kw) -> "StereoConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static description of spatial tiling for the distributed pipeline.

    ``mesh_shape = (ty, tx)`` tiles the image over mesh axes ('ty','tx');
    ``halo`` is the overlap width used both for windowed ops (census/SAD
    radius) and to warm up SGM scan carries at tile borders (SURVEY.md §2.2
    P2/P5). ``halo=None`` derives it from the config.
    """

    mesh_shape: Tuple[int, int] = (1, 1)
    halo: Optional[int] = None
    batch_axis: bool = False           # add a leading 'batch' mesh axis (P1)

    def resolved_halo(self, cfg: StereoConfig) -> int:
        if self.halo is not None:
            return self.halo
        # SGM carry warm-up strip: a border band lets path costs settle
        # before entering the tile interior (bounded-error tiling; the exact
        # cross-tile sequential variant lives in parallel/tiling.py).
        warmup = 16
        return cfg.window_radius + warmup


# ---------------------------------------------------------------------------
# Named presets matching BASELINE.json:6-12 exactly (SURVEY.md §5).
#
# The SGM penalty/gate knobs are TUNED (round 4): staged
# sweeps over the hard adversarial suite (eval/tuning.py; CI scale ->
# D=64 mid scale -> D=128 bench scale; full methodology + tables in
# docs/tuning.md). vs the untuned r3 values (p1=10, p2=120, 5x5 census,
# no gates) at bench scale: textureless 8.8% -> 1.5%, combo 9.8% ->
# 4.5%, periodic 12.5% -> 3.8%, jitter 3.2% -> 0.7% bad3_noc. The
# gates trade density on genuinely ambiguous content (invalid rather
# than wrong; cfg.fill_occlusions recovers coverage when wanted).
# ---------------------------------------------------------------------------

#: Config 1 — Middlebury Tsukuba pair, block SAD, 16 disparities, WTA.
#: Designated "CPU-runnable reference" (BASELINE.json:7): the golden path.
TSUKUBA_SAD16 = StereoConfig(
    cost_fn="sad",
    sad_window=(9, 9),
    num_disparities=16,
    num_paths=0,
    subpixel=False,
    lr_check=True,
    median_filter=True,
)

#: Config 2 — Middlebury half-res (Teddy/Cones), census + 4-path SGM, 64 disp.
MIDDLEBURY_CENSUS_SGM4_64 = StereoConfig(
    cost_fn="census",
    census_window=(9, 7),
    num_disparities=64,
    num_paths=4,
    p1=14,
    p2=120,
    uniqueness_ratio=0.02,
    speckle_rel=80 / (160 * 288),
    subpixel=True,
    lr_check=True,
)

#: Config 3 — KITTI 2015 full-res, 8-path SGM, 128 disp + subpixel + LR-check.
#: The headline speed config (BASELINE.json:2,9): >= 60 fps/chip target.
#: (9, 7) census rides the same 2-word kernel as (7, 7) but measured
#: better on noise/periodic content; uniqueness + speckle are the
#: near-free ambiguity gates (uniqueness is fused in-kernel, speckle is
#: host-side C++). Speckle ships RESOLUTION-RELATIVE:
#: the round-4 sweeps landed on 80 px at the 160x288 suite scale, and
#: blob areas scale with H*W — an absolute 80 under-removes 10x at
#: full KITTI res (docs/tuning.md). speckle_rel keeps the tuned
#: fraction at every resolution (same 80 px at suite scale, bit-for-bit).
KITTI_SGM8_128 = StereoConfig(
    cost_fn="census",
    census_window=(9, 7),
    num_disparities=128,
    num_paths=8,
    p1=14,
    p2=120,
    uniqueness_ratio=0.02,
    speckle_rel=80 / (160 * 288),
    subpixel=True,
    lr_check=True,
)

#: Config 3q — the quality variant: + adaptive P2 with a sensor-noise
#: gradient floor. Clears every hard-suite bar incl. thin structures
#: (the one scenario fixed P2 cannot fix: the smoothness prior erases
#: 2-4 px bars; adaptive P2 relaxes it exactly at intensity edges).
#: Its time per frame is in PERF.md.
KITTI_SGM8_128_QUALITY = KITTI_SGM8_128.replace(
    adaptive_p2=True, adaptive_grad_floor=12, p2_min=30
)

#: Config 4 — Middlebury full-res 2880x1988, 256 disp, tiled with halo
#: exchange (BASELINE.json:10). Pair with TileConfig(mesh_shape=(ty,tx)).
MIDDLEBURY_FULL_256_TILED = StereoConfig(
    cost_fn="census",
    census_window=(9, 7),
    num_disparities=256,
    num_paths=8,
    p1=14,
    p2=120,
    uniqueness_ratio=0.02,
    speckle_rel=80 / (160 * 288),
    subpixel=True,
    lr_check=True,
)

#: Config 5 — batched KITTI video stream, multi-host tile-parallel SGM
#: (BASELINE.json:11). Same per-frame pipeline as config 3; parallelized via
#: the 'batch' mesh axis + tiling in parallel/stream.py.
KITTI_STREAM_MULTIHOST = KITTI_SGM8_128

PRESETS = {
    "tsukuba_sad16": TSUKUBA_SAD16,
    "middlebury_census_sgm4_64": MIDDLEBURY_CENSUS_SGM4_64,
    "kitti_sgm8_128": KITTI_SGM8_128,
    "kitti_sgm8_128_quality": KITTI_SGM8_128_QUALITY,
    "middlebury_full_256_tiled": MIDDLEBURY_FULL_256_TILED,
    "kitti_stream_multihost": KITTI_STREAM_MULTIHOST,
}
