"""A configuration, a traffic mix and a per-layer metric added as new files
(and entries in BENCHMARK.json) are found by name, with no existing file of
the benchmark edited."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def copy(tmp_path, monkeypatch):
    """A copy of the benchmark that the harness reads instead of the repo's."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path / "benchmark")
    return tmp_path


def _snapshot(root):
    return {
        p.relative_to(root): p.read_bytes()
        for p in (root / "benchmark").rglob("*") if p.is_file()
    }


def test_new_files_are_found(copy):
    before = _snapshot(copy)
    bench = copy / "benchmark"
    kitti = json.loads((bench / "configs/kitti2015_census_sgm8_d128.json").read_text())
    tiny = dict(kitti, name="tiny_census_d16",
                frame={"height": 24, "width": 48},
                stereo=dict(kitti["stereo"], num_disparities=16, num_paths=4),
                scene=dict(kitti["scene"], max_disp=10))
    (bench / "configs/tiny_census_d16.json").write_text(json.dumps(tiny))
    (bench / "traffic/rig_pool4.json").write_text(json.dumps(
        {"kind": "rig", "pool": 4, "check": {"frames": 2}, "trace_seconds": 0.2}
    ))
    (bench / "metrics/frames_traced.py").write_text(
        '"""Frames completed in the traced stretch."""\n\n\n'
        "def read(view):\n    return float(view.frames_traced) or None\n"
    )
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tiny_census_d16", "source": "https://example.org/tiny",
        "file": "benchmark/configs/tiny_census_d16.json", "reduced": [],
        "why": "a test configuration",
    })
    spec["workloads"].append({
        "name": "tiny.rig", "config": "tiny_census_d16",
        "traffic": "rig_pool4", "chips": 1, "why": "a test cell",
    })
    spec["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "serve loop", "moves": "fps",
        "workloads": ["tiny.rig"],
    })
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    run = harness.run_cell("tiny.rig", 3, 0.6, True, require_gpu=False)
    assert run.correct
    assert run.per_layer["frames_traced"] > 0
    assert run.end_to_end["fps"] > 0 and "latency_p95_ms" in run.end_to_end
    after = _snapshot(copy)
    assert all(after[k] == v for k, v in before.items())
    assert {str(k) for k in set(after) - set(before)} == {
        "benchmark/configs/tiny_census_d16.json",
        "benchmark/traffic/rig_pool4.json",
        "benchmark/metrics/frames_traced.py",
    }


def test_unknown_names_raise(copy):
    with pytest.raises(KeyError, match="no workload"):
        harness.run_cell("no.such.cell", 1, 0.1, False, require_gpu=False)
    with pytest.raises(FileNotFoundError):
        harness.load_traffic("no_such_mix")
