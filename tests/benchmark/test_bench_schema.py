"""BENCHMARK.json against the benchmark's contract, and its files by name."""

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {
        "command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer",
    }
    assert SPEC["command"][0] == "python3"
    assert all(Path(p).parts[0] in ("benchmark", "tests") for p in SPEC["paths"])
    assert (ROOT / SPEC["command"][1]).is_file()
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize(
    "entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
    ids=lambda e: e["name"],
)
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_listed(metric):
    """Each cell that lists a per-layer metric reports the end-to-end metric
    the per-layer one should move, and a reader file exists for it."""
    moved = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]
    from benchmark import harness

    assert callable(harness.load_reader(metric["name"]))


def test_layer_names_agree():
    """Metrics of one layer use one spelling; no two spellings collide."""
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert len({x.lower() for x in layers}) == len(layers)


@pytest.mark.parametrize("metric", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


def test_setup_and_cells_report_enough():
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names
    for cell in CELLS:
        e2e = [m for m in SPEC["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        layer = [m for m in SPEC["per_layer"]
                 if "workloads" not in m or cell in m["workloads"]]
        assert len(e2e) >= 2 and layer


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    from stereo_tpu import StereoConfig

    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    path = ROOT / config["file"]
    assert path.is_file() and Path(config["file"]).parts[0] == "benchmark"
    body = json.loads(path.read_text())
    assert body["reduced"] == config["reduced"]
    stereo = {k: tuple(v) if isinstance(v, list) else v
              for k, v in body["stereo"].items()}
    StereoConfig(**stereo)
    assert body["frame"]["height"] > 0 and body["assumed"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    traffic = json.loads(
        (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text()
    )
    assert traffic["kind"] in ("rig", "stream")
    assert cell["chips"] in (1, 4)
    if traffic["kind"] == "stream":
        assert traffic["pool"] % (traffic["frames_per_card"] * cell["chips"]) == 0


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(0.25 * len(SPEC["workloads"])))


def test_run_seconds_fits_a_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
