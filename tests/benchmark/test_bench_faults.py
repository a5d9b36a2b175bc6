"""The whole harness on the CPU at a small size, past its look for a chip,
with the timed path broken underneath: ``correct`` has to come out false.

Faults a cell can have: an answer altered where it is produced (every cell);
half of each batch left out; the results of every card but the first left
out (the four-card cell). The int4 control (the
reference one precision below the configuration's int8 volume) has to fail
too, and the unbroken program has to pass.
"""

from typing import NamedTuple

import pytest

from benchmark import harness
from benchmark.control import control_patch

SMALL = {
    "frame": {"height": 24, "width": 64},
    "stereo": {"num_disparities": 16},
    "scene": {"max_disp": 12},
}
SECONDS = 0.3


class Out(NamedTuple):
    disp: object
    valid: object


def altered(fn):
    def broken(left, right):
        out = fn(left, right)
        return Out(out.disp.at[..., 4:12, 20:40].add(3.0), out.valid)
    return broken


def half_batch(fn):
    def broken(left, right):
        out = fn(left, right)
        half = out.disp.shape[0] // 2
        return Out(out.disp.at[half:].set(0.0), out.valid.at[half:].set(False))
    return broken


def first_card_only(fn):
    def broken(left, right):
        out = fn(left, right)
        per_card = out.disp.shape[0] // 4
        return Out(out.disp.at[per_card:].set(0.0),
                   out.valid.at[per_card:].set(False))
    return broken


def run(workload, patch=None):
    return harness.run_cell(workload, 2**31 + 99, SECONDS, False,
                            require_gpu=False, overrides=SMALL, patch=patch)


@pytest.mark.parametrize(
    "workload", ["kitti.stream", "middlebury.stream", "kitti.stream4"]
)
def test_program_passes(workload):
    r = run(workload)
    assert r.correct and r.failed == 0 and r.attempted > 0
    assert all(c["value"] == 0.0 for c in r.checks.values())
    line = harness.result_line(r, workload, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    rate = "fps_4card" if workload == "kitti.stream4" else "fps"
    assert set(line["metrics"]) == {rate, "setup_s"}
    assert line["device"]["count"] == (4 if workload == "kitti.stream4" else 1)


@pytest.mark.parametrize("workload,fault", [
    ("kitti.stream", altered),
    ("kitti.stream", half_batch),
    ("kitti.stream4", half_batch),
    ("kitti.stream4", first_card_only),
    ("middlebury.stream", altered),
])
def test_fault_is_not_correct(workload, fault):
    r = run(workload, fault)
    assert not r.correct and r.failed > 0
    assert r.checks["mismatch_pct"]["value"] > r.checks["mismatch_pct"]["limit"]


@pytest.mark.parametrize(
    "workload", ["kitti.stream", "middlebury.stream", "kitti.stream4"]
)
def test_int4_control_is_not_correct(workload):
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], workload, "workload")
    config = harness.merge_overrides(
        harness.load_config(spec, cell["config"]), SMALL
    )
    kind = harness.load_traffic(cell["traffic"])["kind"]
    r = run(workload, control_patch(config, kind))
    assert not r.correct
