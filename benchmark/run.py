"""Run one benchmark cell and print its result as the last line of stdout.

    python3 benchmark/run.py --workload kitti.rig --seed 7 --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics (host clock, profiler
off); ``--trace 1`` profiles a stretch of the window and reports the cell's
per-layer metrics with the device's busy time and a breakdown. Each run
compares a seeded sample of the frames its window produced with the plain
reference and prints every compared number beside its limit, as the last
lines of stderr and under ``checks``, the last key of the result line.

Exits non-zero without a result line when JAX finds no GPU, fewer GPUs than
the cell asks for, or no program to measure. ``--keep-trace DIR`` keeps the
raw trace and the program's HLO text there (trace runs only).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--keep-trace")
    args = ap.parse_args()

    from benchmark import harness

    harness.enable_compile_cache()
    try:
        run = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace), t0=T0,
            keep_trace=args.keep_trace,
        )
    except harness.NoChip as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    try:
        result = harness.result_line(run, args.workload, bool(args.trace))
    except ValueError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    for note in run.notes:
        print(note, flush=True)
    if not args.trace:
        extra = {k: v for k, v in run.end_to_end.items()
                 if k not in result["metrics"]}
        print("also measured: " + json.dumps(extra), flush=True)
    print(f"correct: {run.correct}", file=sys.stderr, flush=True)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
