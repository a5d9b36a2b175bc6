"""The check's control: the reference in the program's place, one precision down.

The configurations state an int8 cost volume (census costs of at most 62).
The control runs the plain reference with an int4 volume instead (each cost
kept as cost >> 2, scaled back), the step a later change could be tempted to
take, through the cell's own traffic, window and check. Its numbers set the
upper end of each limit; the check has to call it not correct.

    python3 benchmark/control.py --workload kitti.rig --seconds 5 --seeds 11 12 13

prints one JSON line per seed with the compared numbers (the benchmark's own
runs never run this).
"""

import argparse
import json
import os
import sys
from typing import NamedTuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Out(NamedTuple):
    disp: object
    valid: object


def control_patch(config: dict, kind: str, cost_bits: int = 4):
    """``patch`` for ``harness.run_cell``: the int4 reference in place of
    the program's compiled call."""
    import jax

    from benchmark.reference import params_from_config
    from benchmark.reference.stereo import frame

    p = params_from_config(config["stereo"], cost_bits=cost_bits)
    if kind == "rig":
        one = jax.jit(lambda left, right: Out(*frame(left, right, p)))
        return lambda _program: one

    def batched(left, right):
        return Out(*jax.lax.map(lambda lr: frame(lr[0], lr[1], p), (left, right)))

    many = jax.jit(batched)
    return lambda _program: many


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()

    from benchmark import harness

    harness.enable_compile_cache()
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    config = harness.load_config(spec, cell["config"])
    kind = harness.load_traffic(cell["traffic"])["kind"]
    for seed in args.seeds:
        run = harness.run_cell(
            args.workload, seed, args.seconds, False,
            patch=control_patch(config, kind),
        )
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": "int4 cost",
            "correct": run.correct, "checks": run.checks,
            "frames": run.attempted,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
