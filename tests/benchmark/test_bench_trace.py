"""Trace reduction on a trace recorded on an H100: busy union, idle share,
attribution of kernels to layers through the HLO's stack frames, and
``other``. The fixture is 63 frames of ``kitti.rig`` traced by
``benchmark/run.py --trace 1 --keep-trace`` (NVIDIA H100 80GB HBM3, 700 W)."""

import gzip
from pathlib import Path

import pytest

from benchmark import harness, trace

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def recorded():
    import jax

    prof = jax.profiler.ProfileData.from_serialized_xspace(
        gzip.open(FIXTURES / "kitti_rig.xplane.pb.gz").read()
    )
    hlo = gzip.open(FIXTURES / "kitti_rig_hlo.txt.gz", "rt").read()
    return prof, trace.kernel_modules(hlo)


def test_merge_and_gaps():
    busy = trace.merge([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)])
    assert busy == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.gaps(busy, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert trace.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_window_busy_and_idle(recorded):
    prof, modules = recorded
    red = trace.reduce(prof, modules, harness.load_layers(), [0])
    assert red.window_s == pytest.approx(1.521762488)
    events = [e for e in trace.device_events(prof)
              if e.end > 0 and e.start < 1e9]
    summed = sum(e.end - e.start for e in events)
    # Overlapping copies and kernels count once: busy <= the plain sum.
    assert 0 < red.busy_s[0] <= summed + 1e-12
    idle = 1 - red.busy_s[0] / red.window_s
    assert 0.6 < idle < 0.8
    assert sum(red.gap_s.values()) == pytest.approx(red.window_s - red.busy_s[0])


def test_gaps_named_by_host_span(recorded):
    prof, modules = recorded
    red = trace.reduce(prof, modules, harness.load_layers(), [0])
    top = red.top_gaps()
    assert top[0][0] == "host_post"
    assert {name for name, _ in top} <= set(trace.SPAN_NAMES) | {"no benchmark span"}


def test_stack_frame_attribution(recorded):
    prof, modules = recorded
    assert modules["input_reduce_fusion_1"] == "stereo_tpu/ops/census.py"
    assert modules["input_transpose_fusion"] == "stereo_tpu/ops/postprocess.py"
    layers = harness.load_layers()
    assert trace.layer_of("input_reduce_fusion_1", modules, layers) == "cost_volume"
    assert trace.layer_of("sgm_path_10", modules, layers) == "sgm"
    assert trace.layer_of("MemcpyD2H", modules, layers) == "transfer"
    red = trace.reduce(prof, modules, layers, [0])
    assert set(red.layer_s) == {"cost_volume", "sgm", "select_post", "transfer"}
    assert red.layer_s["cost_volume"] / 63 == pytest.approx(4.04e-3, rel=0.05)


def test_unmapped_kernels_are_other(recorded):
    prof, modules = recorded
    layers = harness.load_layers()
    assert trace.layer_of("no_such_fusion_7", modules, layers) == trace.OTHER
    red = trace.reduce(prof, {}, layers, [0])
    assert red.layer_s[trace.OTHER] > 0
    assert "cost_volume" not in red.layer_s
    assert red.layer_s["sgm"] > 0   # named by prefix, no HLO needed
    full = trace.reduce(prof, modules, layers, [0])
    assert sum(red.layer_s.values()) == pytest.approx(sum(full.layer_s.values()))


def test_breakdown_shape(recorded):
    prof, modules = recorded
    red = trace.reduce(prof, modules, harness.load_layers(), [0])
    ops = red.top_ops()
    assert len(ops) == 10
    assert ops[0][0] == "cost_volume:input_reduce_fusion_1"
    assert all(isinstance(s, float) for _, s in ops)


def test_kernel_modules_parses_a_small_module():
    hlo = """HloModule jit_f

FileNames
1 "/x/bench.py"
2 "/x/stereo_tpu/ops/wta.py"

FunctionNames
1 "f"

FileLocations
1 {file_name_id=1 function_name_id=1 line=1 end_line=1 column=1 end_column=2}
2 {file_name_id=2 function_name_id=1 line=5 end_line=5 column=1 end_column=2}

StackFrames
1 {file_location_id=1 parent_frame_id=1}
2 {file_location_id=2 parent_frame_id=2}

%fused_min (p: s32[4,8]) -> s32[4] {
  %p = s32[4,8]{1,0} parameter(0)
  ROOT %r = s32[4]{0} reduce(%p), metadata={op_name="min" stack_frame_id=2}
}

ENTRY %main (a: s32[4,8]) -> s32[4] {
  %a = s32[4,8]{1,0} parameter(0), metadata={op_name="a"}
  ROOT %input_reduce_fusion.3 = s32[4]{0} fusion(%a), kind=kInput, calls=%fused_min
  %copy.1 = s32[4]{0} copy(%a), metadata={op_name="c" stack_frame_id=1}
}
"""
    mods = trace.kernel_modules(hlo)
    assert mods["input_reduce_fusion_3"] == "stereo_tpu/ops/wta.py"
    assert "copy_1" not in mods   # only outside stereo_tpu
