"""One run of one benchmark cell: set-up, the measured window, the check.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file (``configs/``), its traffic mix (``traffic/``), the
layers of the device trace (``layers/``), one reader per per-layer metric
(``metrics/``) and the limits of the check (``limits/``). Adding a cell, a
mix, a layer or a metric adds files and entries; this module stays as it is.

Traffic kinds (the ``kind`` of a mix):

``rig``
  a closed loop, one frame at a time through ``build_pipeline``: upload
  (``device_put``), dispatch, ``block_until_ready``, ``device_get`` and
  ``host_postprocess``. Latency runs from taking the pair from host memory
  to the filtered disparity and mask being on the host.
``stream``
  ``StreamRunner.run_batches`` over ``build_stream_pipeline`` on a
  ``batch`` mesh of the cell's cards: host batches of ``frames_per_card``
  frames per card are uploaded inside the window, at most ``in_flight``
  batches are in flight, and results stay on the device behind the
  runner's completion proof.

Frames come from a pool of ``pool`` seeded pairs; frame k uses pair
k mod pool. After the window, a seeded sample of the frames the window
produced is compared with the plain reference (``reference/``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import gzip
import importlib.util
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class NoChip(RuntimeError):
    """JAX found no GPU, or fewer than the cell asks for."""


# --------------------------------------------------------------------------
# Finding things by name
# --------------------------------------------------------------------------


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str) -> dict:
    return load_json(ROOT / find(spec["configs"], name, "configuration")["file"])


def load_traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def load_layers() -> Dict[str, dict]:
    return {
        p.stem: load_json(p) for p in sorted((BENCH_DIR / "layers").glob("*.json"))
    }


def load_reader(name: str) -> Callable:
    """``metrics/<name>.py``; a metric ``<base>.<variant>`` (one quantity
    split by the end-to-end metric it moves) is read by ``<base>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path
    )
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def load_limits(workload: str) -> dict:
    limits = load_json(BENCH_DIR / "limits" / "default.json")
    own = BENCH_DIR / "limits" / f"{workload}.json"
    if own.exists():
        limits.update(load_json(own))
    return limits


def load_peaks(device_kind: str) -> dict:
    table = load_json(BENCH_DIR / "peaks.json")
    if device_kind not in table:
        raise KeyError(
            f"no peaks for device kind {device_kind!r} in benchmark/peaks.json"
        )
    return table[device_kind]


def metrics_of(spec: dict, section: str, workload: str) -> List[dict]:
    return [
        m for m in spec[section]
        if "workloads" not in m or workload in m["workloads"]
    ]


def merge_overrides(config: dict, overrides: Optional[dict]) -> dict:
    """A copy of ``config`` with the groups of ``overrides`` merged in
    (tests run the harness at small sizes on the CPU)."""
    config = json.loads(json.dumps(config))
    for group, values in (overrides or {}).items():
        config.setdefault(group, {}).update(values)
    return config


def enable_compile_cache() -> str:
    """JAX's persistent cache: ``$JAX_COMPILATION_CACHE_DIR``, else the
    checkout's ``.jax_cache``; every program is cached, however small."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


# --------------------------------------------------------------------------
# Host spans, the card's clocks, compilations
# --------------------------------------------------------------------------


class Spans:
    """Host spans around the benchmark's calls into the program: summed in
    memory and written into the profiler's trace when one is running."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        import jax

        with jax.profiler.TraceAnnotation(name):
            t = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t
                self.seconds[name] = self.seconds.get(name, 0.0) + dt


class CardSampler:
    """nvidia-smi in a child process (off JAX) sampling the card's name,
    power limit, SM clock and power draw every 500 ms beside the window."""

    QUERY = "name,power.limit,clocks.sm,power.draw"

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            )
        except OSError:
            self.proc = None

    def stop(self) -> str:
        if self.proc is None:
            return "nvidia-smi not available"
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = [r.split(", ") for r in out.splitlines() if r.count(", ") == 3]
        if not rows:
            return "no nvidia-smi samples"
        card0 = [r for r in rows if r[0] == rows[0][0]]
        clocks = [float(r[2]) for r in card0 if r[2].replace(".", "").isdigit()]
        power = [float(r[3]) for r in card0 if r[3].replace(".", "").isdigit()]
        med = lambda xs: float(np.median(xs)) if xs else float("nan")  # noqa: E731
        return (
            f"{rows[0][0]}, power limit {rows[0][1]} W, SM clock median "
            f"{med(clocks)} MHz (min {min(clocks, default=float('nan'))}, "
            f"max {max(clocks, default=float('nan'))}), power draw median "
            f"{med(power)} W, {len(card0)} samples"
        )


class CompileCounter:
    """Counts compilations and compile-cache reads while ``on``."""

    def __init__(self):
        import jax

        self.n = 0
        self.on = False
        self._jax = jax
        jax.monitoring.register_event_duration_secs_listener(self._event)

    def _event(self, event: str, duration: float, **_) -> None:
        if self.on and "compil" in event:
            self.n += 1

    def close(self) -> None:
        self._jax.monitoring.unregister_event_duration_listener(self._event)


class Reservoir:
    """A uniform sample of ``k`` items from a stream, drawn from a seed."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


# --------------------------------------------------------------------------
# The two loops
# --------------------------------------------------------------------------


class RigLoop:
    def __init__(self, fn, pool, device, host_post, spans, reservoir):
        self.fn, self.pool, self.device = fn, pool, device
        self.host_post, self.spans, self.reservoir = host_post, spans, reservoir
        self.frames = 0
        self.latency: List[float] = []

    def run(self, deadline: float = float("inf"), limit=None) -> int:
        """Frames until ``deadline`` (perf_counter) or ``limit`` frames."""
        import jax

        spans, start = self.spans, self.frames
        while time.perf_counter() < deadline and (
            limit is None or self.frames - start < limit
        ):
            k = self.frames
            pair = self.pool[k % len(self.pool)]
            t = time.perf_counter()
            with spans("upload"):
                left = jax.device_put(pair.left, self.device)
                right = jax.device_put(pair.right, self.device)
            with spans("dispatch"):
                out = self.fn(left, right)
            with spans("wait"):
                out = jax.block_until_ready(out)
            with spans("download"):
                disp, valid = jax.device_get(tuple(out))
            with spans("host_post"):
                disp, valid = self.host_post(disp, valid)
            self.latency.append(time.perf_counter() - t)
            self.reservoir.offer((k, disp, valid))
            self.frames += 1
        return self.frames - start

    def samples(self, rng):
        n = len(self.pool)
        return [(k % n, np.asarray(d), np.asarray(v))
                for k, d, v in self.reservoir.items]


class StreamLoop:
    def __init__(self, runner, host_batches, sharding, spans, reservoir,
                 per_batch: int):
        self.runner, self.host_batches = runner, host_batches
        self.sharding, self.spans, self.reservoir = sharding, spans, reservoir
        self.per_batch = per_batch
        self.batches = 0
        self.frames = 0

    def run(self, deadline: float = float("inf"), limit=None) -> int:
        """Batches until ``deadline`` (perf_counter) or ``limit`` batches;
        returns the frames completed."""
        import jax

        spans = self.spans
        issued = [self.batches]
        first = self.batches

        def batches():
            while time.perf_counter() < deadline and (
                limit is None or issued[0] - first < limit
            ):
                with spans("next_batch"):
                    left, right = self.host_batches[
                        issued[0] % len(self.host_batches)
                    ]
                with spans("upload"):
                    left = jax.device_put(left, self.sharding)
                    right = jax.device_put(right, self.sharding)
                issued[0] += 1
                yield left, right

        def on_result(res):
            self.reservoir.offer((self.batches, res))
            self.batches += 1

        # Each call is a stream of its own: run_batches skips the frames
        # before its resume cursor, so the cursor starts at 0.
        self.runner.frames_done = 0
        self.runner.run_batches(batches(), on_result=on_result,
                                checkpoint_every=0)
        done = self.runner.frames_done
        self.frames += done
        return done

    def samples(self, rng):
        b = self.host_batches[0][0].shape[0]
        stride = b // self.per_batch
        out = []
        for bi, res in self.reservoir.items:
            base = (bi % len(self.host_batches)) * b
            for k in range(self.per_batch):
                j = k * stride + int(rng.integers(stride))
                out.append((base + j, np.asarray(res.disp[j]),
                            np.asarray(res.valid[j])))
        return out


# --------------------------------------------------------------------------
# The check
# --------------------------------------------------------------------------


def compare(disp, valid, ref_disp, ref_valid, tol_px: float):
    """(mismatch_pct, max_gap_px) of one frame against the reference.

    mismatch: pixels whose valid bit differs, or valid in the reference
    with a disparity off by more than tol_px (NaN counts as off).
    max gap: the largest disparity difference where both are valid.
    """
    gap = np.abs(np.asarray(disp, np.float64) - np.asarray(ref_disp, np.float64))
    gap = np.where(np.isnan(gap), np.inf, gap)
    valid, ref_valid = np.asarray(valid, bool), np.asarray(ref_valid, bool)
    bad = (valid != ref_valid) | (ref_valid & ~(gap <= tol_px))
    both = valid & ref_valid
    return (
        100.0 * float(bad.mean()),
        float(gap[both].max()) if both.any() else 0.0,
    )


def check(samples, pool, config: dict, host_post: bool, limits: dict):
    """Compare sampled frames with the reference; numbers and verdict."""
    import jax

    from .reference import jitted, params_from_config, speckle

    p = params_from_config(config["stereo"])
    ref_fn = jitted(p)
    want = {}
    for idx in sorted({s[0] for s in samples}):
        d, v = jax.device_get(ref_fn(pool[idx].left, pool[idx].right))
        if host_post:
            v = speckle(d, v, p)
        want[idx] = (d, v)
    worst = {"mismatch_pct": 0.0, "max_gap_px": 0.0}
    failed = 0
    for idx, d, v in samples:
        mis, gap = compare(d, v, *want[idx], limits["tol_px"])
        failed += int(mis > limits["mismatch_pct"] or gap > limits["max_gap_px"])
        worst["mismatch_pct"] = max(worst["mismatch_pct"], mis)
        worst["max_gap_px"] = max(worst["max_gap_px"], gap)
    checks = {
        name: {"value": value, "limit": limits[name]}
        for name, value in worst.items()
    }
    correct = bool(samples) and all(
        c["value"] <= c["limit"] for c in checks.values()
    )
    return correct, failed, checks


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    correct: bool
    attempted: int
    failed: int
    checks: dict
    end_to_end: Dict[str, float]
    per_layer: Dict[str, float]
    device: dict
    breakdown: Optional[dict]
    notes: List[str]


def _stereo_config(stereo: dict):
    from stereo_tpu import StereoConfig

    kw = dict(stereo)
    for key in ("census_window", "sad_window"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return StereoConfig(**kw)


def _pool(config: dict, traffic: dict, seed: int):
    from .gen import make_pair, pair_seed

    shape = (config["frame"]["height"], config["frame"]["width"])
    scene = config["scene"]
    return [
        make_pair(shape, scene["max_disp"], scene["kind"], scene["texture"],
                  seed=pair_seed(seed, i))
        for i in range(traffic["pool"])
    ]


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    t0: Optional[float] = None,
    require_gpu: bool = True,
    overrides: Optional[dict] = None,
    patch: Optional[Callable] = None,
    keep_trace: Optional[str] = None,
) -> Run:
    """Set up, measure ``seconds``, check; see the module docstring.

    ``patch(fn)`` replaces the program's compiled call (the jitted pipeline,
    or the stream runner's batched pipeline) before set-up: the control and
    the fault tests run the rest of the harness unchanged around it.
    """
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec()
    cell = find(spec["workloads"], workload, "workload")
    config = merge_overrides(load_config(spec, cell["config"]), overrides)
    traffic = load_traffic(cell["traffic"])
    chips = int(cell["chips"])

    import jax

    if require_gpu and jax.default_backend() != "gpu":
        raise NoChip(f"JAX runs on {jax.default_backend()!r}, not on a GPU")
    devices = jax.devices()
    if len(devices) < chips:
        raise NoChip(f"the cell needs {chips} devices, JAX has {len(devices)}")
    devices = devices[:chips]
    kind = devices[0].device_kind
    peaks = load_peaks(kind) if require_gpu else None

    from stereo_tpu.pipeline.pipeline import build_pipeline, host_postprocess

    cfg = _stereo_config(config["stereo"])
    shape = (config["frame"]["height"], config["frame"]["width"])
    pool = _pool(config, traffic, seed)
    rng = np.random.default_rng([seed % (1 << 64), 1])
    notes: List[str] = []
    counter = CompileCounter()

    def new_loop(spans):
        if traffic["kind"] == "rig":
            res = Reservoir(traffic["check"]["frames"], rng)
            return RigLoop(
                program, pool, devices[0],
                lambda d, v: host_postprocess(d, v, cfg), spans, res,
            )
        res = Reservoir(traffic["check"]["batches"], rng)
        return StreamLoop(runner, host_batches, sharding, spans, res,
                            traffic["check"]["frames_per_batch"])

    if traffic["kind"] == "rig":
        compiled_fn = build_pipeline(cfg)
        program = patch(compiled_fn) if patch else compiled_fn
        host_post = True
        warm_calls = 2
    elif traffic["kind"] == "stream":
        from jax.sharding import NamedSharding, PartitionSpec

        from stereo_tpu.parallel import StreamRunner, make_tile_mesh

        class Runner(StreamRunner):
            span = None

            def _completion_proof(self, arr):
                with self.span("wait"):
                    StreamRunner._completion_proof(arr)

        batch = traffic["frames_per_card"] * chips
        if traffic["pool"] % batch:
            raise ValueError("a stream mix's pool must hold whole batches")
        mesh = make_tile_mesh(devices, (1, 1), batch=chips)
        runner = Runner(cfg, mesh, shape, batch_size=batch,
                        max_in_flight=traffic["in_flight"])
        compiled_fn = runner.pipeline
        inner = patch(compiled_fn) if patch else compiled_fn
        sharding = NamedSharding(mesh, PartitionSpec("batch"))
        host_batches = [
            (np.stack([p.left for p in pool[i:i + batch]]),
             np.stack([p.right for p in pool[i:i + batch]]))
            for i in range(0, len(pool), batch)
        ]
        host_post = False
        warm_calls = traffic["in_flight"] + 1
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")

    def set_spans(spans):
        if traffic["kind"] == "stream":
            Runner.span = spans

            def dispatch(left, right):
                with spans("dispatch"):
                    return inner(left, right)

            runner.pipeline = dispatch

    # Set-up: warm every shape the window uses, through the window's loop.
    warm_spans = Spans()
    set_spans(warm_spans)
    new_loop(warm_spans).run(limit=warm_calls)
    gc.collect()

    spans = Spans()
    set_spans(spans)
    drv = new_loop(spans)
    sampler = CardSampler() if require_gpu else None
    counter.on = True
    t_start = time.perf_counter()
    setup_s = t_start - t0
    trace_dir = tempfile.mkdtemp(prefix="bench_trace_") if trace else None
    try:
        frames_traced = _window(drv, t_start, seconds, trace_dir,
                                traffic["trace_seconds"])
        t_end = time.perf_counter()
    finally:
        counter.on = False
        counter.close()
        card = sampler.stop() if sampler is not None else None
    window_s = t_end - t_start
    notes.append(f"compilations in the window: {counter.n}")
    if card is not None:
        notes.append("card: " + card)

    stats = [d.memory_stats() or {} for d in devices]
    memory_peak = max(int(s.get("peak_bytes_in_use", 0)) for s in stats)

    device = {
        "platform": devices[0].platform,
        "kind": kind,
        "count": chips,
        "memory_peak_bytes": memory_peak,
    }
    breakdown = None
    per_layer: Dict[str, float] = {}
    if trace:
        from . import trace as trace_mod

        hlo = _hlo_text(compiled_fn, pool, traffic, host_batches
                        if traffic["kind"] == "stream" else None, devices)
        modules = trace_mod.kernel_modules(hlo) if hlo else {}
        if not hlo:
            notes.append("no HLO text: kernels are attributed by name only")
        xplane = sorted(glob.glob(
            os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
        ))[-1]
        prof = jax.profiler.ProfileData.from_file(xplane)
        cards = [d.id for d in devices]
        reduction = trace_mod.reduce(prof, modules, load_layers(), cards)
        if keep_trace:
            os.makedirs(keep_trace, exist_ok=True)
            shutil.copy(xplane, os.path.join(keep_trace, "trace.xplane.pb"))
            with gzip.open(os.path.join(keep_trace, "hlo.txt.gz"), "wt") as f:
                f.write(hlo or "")
        shutil.rmtree(trace_dir, ignore_errors=True)
        device["busy_s"] = sum(reduction.busy_s.values()) / max(
            1, len(reduction.busy_s)
        )
        device["window_s"] = reduction.window_s
        breakdown = {
            "device_ops": reduction.top_ops(),
            "idle_gaps": reduction.top_gaps(),
        }
        from .counts import stage_counts
        from .view import View

        view = View(
            reduction=reduction, frames_traced=frames_traced,
            frames_window=drv.frames, span_s=dict(spans.seconds),
            counts=stage_counts(config), peaks=peaks, chips=chips,
        )
        for m in metrics_of(spec, "per_layer", workload):
            value = load_reader(m["name"])(view)
            if value is not None:
                per_layer[m["name"]] = float(value)
        notes.append(
            f"traced {frames_traced} frames in {reduction.window_s:.4f} s; "
            "device seconds by layer: "
            + json.dumps({k: v for k, v in sorted(reduction.layer_s.items())})
        )

    end_to_end = {"fps": drv.frames / window_s, "setup_s": setup_s}
    if chips > 1:
        # Feeding several cards from one host process spreads wider than one
        # card does, so the multi-card rate is a metric with its own bound.
        end_to_end[f"fps_{chips}card"] = end_to_end["fps"]
    if traffic["kind"] == "rig":
        end_to_end["latency_p95_ms"] = 1e3 * float(
            np.percentile(drv.latency, 95)
        )
    notes.append(
        f"window {window_s:.3f} s, {drv.frames} frames, host span seconds "
        + json.dumps({k: round(v, 6) for k, v in sorted(spans.seconds.items())})
    )

    # The check, once the window has closed and the program is freed.
    attempted = drv.frames
    samples = drv.samples(rng)
    del drv, warm_spans
    if traffic["kind"] == "stream":
        del runner, inner
    else:
        del program
    del compiled_fn
    gc.collect()
    t_check = time.perf_counter()
    limits = load_limits(workload)
    correct, failed, checks = check(samples, pool, config, host_post, limits)
    notes.append(
        f"checked {len(samples)} frames against the reference in "
        f"{time.perf_counter() - t_check:.3f} s"
    )
    return Run(
        correct=correct, attempted=attempted,
        failed=failed, checks=checks, end_to_end=end_to_end,
        per_layer=per_layer, device=device, breakdown=breakdown, notes=notes,
    )


def _window(drv, t_start: float, seconds: float, trace_dir: Optional[str],
            trace_seconds: float) -> int:
    """Drive the window; with ``trace_dir``, profile a stretch of
    ``trace_seconds`` from 40% of it on. Returns the frames traced."""
    import jax

    if trace_dir is None:
        drv.run(t_start + seconds)
        return 0
    drv.run(t_start + 0.4 * seconds)
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.host_tracer_level = 1
    jax.profiler.start_trace(trace_dir, profiler_options=opts)
    try:
        with jax.profiler.TraceAnnotation("traced_window"):
            f0 = drv.frames
            drv.run(time.perf_counter() + trace_seconds)
            traced = drv.frames - f0
    finally:
        jax.profiler.stop_trace()
    drv.run(t_start + seconds)
    return traced


def result_line(run: Run, workload: str, trace: bool) -> dict:
    """The run's result line: the cell's end-to-end metrics (``trace``
    False) or per-layer metrics (True), then ``checks`` as the last key."""
    spec = load_spec()
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    section = "per_layer" if trace else "end_to_end"
    values = run.per_layer if trace else run.end_to_end
    wanted = [m["name"] for m in metrics_of(spec, section, workload)]
    missing = [n for n in wanted if n not in values]
    if missing and not trace:
        raise ValueError(f"no value for {missing}")
    result = {
        "correct": run.correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": {
            n: {"value": values[n], "unit": units[n]} for n in wanted
            if n in values
        },
        "device": run.device,
    }
    if run.breakdown is not None:
        result["breakdown"] = run.breakdown
    result["checks"] = run.checks
    return result


def _hlo_text(fn, pool, traffic, host_batches, devices) -> str:
    """Optimized HLO of the window's program (the compile cache serves it)."""
    import jax

    try:
        if host_batches is not None:
            left, right = host_batches[0]
        else:
            left = jax.device_put(pool[0].left, devices[0])
            right = jax.device_put(pool[0].right, devices[0])
        return fn.lower(left, right).compile().as_text()
    except Exception:  # noqa: BLE001 - attribution then falls back to names
        return ""
