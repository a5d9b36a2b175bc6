"""CLI command tests on the fake-device CPU backend."""

import json
import os

import numpy as np
import pytest

from stereo_tpu.cli import main


SMALL = ["--set", "num_disparities=16"]


def test_cli_stream_synthetic(tmp_path, capsys):
    rc = main([
        "stream", "--preset", "kitti_sgm8_128", *SMALL,
        "--limit", "4", "--batch", "2", "--batch-axis", "2",
        "--tiles", "1,1", "--demo-shape", "48", "80",
        "--manifest", str(tmp_path / "m.json"),
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    stats = json.loads(out)
    assert stats["frames"] == 4


def test_cli_run_rank_cost(tmp_path, capsys):
    rc = main([
        "run", "--demo", "--demo-shape", "48", "80", "--demo-max-disp", "8",
        "--preset", "kitti_sgm8_128", "--set", "num_disparities=16",
        "--set", "cost_fn=rank",
        "--out", str(tmp_path / "d.pfm"),
    ])
    assert rc == 0
    assert os.path.exists(tmp_path / "d.pfm")
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["bad3"] < 0.05


def test_cli_run_fill_occlusions(capsys):
    """--set fill_occlusions=true reaches host_postprocess: density ~1."""
    rc = main([
        "run", "--demo", "--demo-shape", "48", "80", "--demo-max-disp", "8",
        "--preset", "kitti_sgm8_128", *SMALL,
        "--set", "fill_occlusions=true",
    ])
    assert rc == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["density"] > 0.999
    assert m["bad3"] < 0.10


def test_cli_scale_harness(capsys):
    """cli scale on fake devices: rows are valid JSON with sane fields
    (validates the instrument, not the hardware)."""
    rc = main([
        "scale", "--preset", "kitti_sgm8_128", *SMALL,
        "--demo-shape", "48", "80", "--devices", "1,2", "--iters", "2",
    ])
    assert rc == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["fps"] > 0
        assert 0 < r["efficiency"] <= 1.5
    assert rows[0]["efficiency"] == 1.0


def test_cli_bench_quick(capsys):
    rc = main([
        "bench", "--preset", "middlebury_census_sgm4_64", *SMALL,
        "--demo-shape", "48", "80", "--demo-max-disp", "8", "--iters", "3",
    ])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["fps"] > 0


def test_cli_run_pyramid_model(capsys):
    rc = main([
        "run", "--demo", "--demo-shape", "64", "96", "--demo-max-disp", "12",
        "--preset", "kitti_sgm8_128", "--set", "num_disparities=32",
        "--model", "pyramid",
    ])
    assert rc == 0


def test_cli_run_depth_and_ply(tmp_path, capsys):
    depth = tmp_path / "z.npy"
    ply = tmp_path / "cloud.ply"
    rc = main([
        "run", "--demo", "--demo-shape", "48", "80", "--demo-max-disp", "8",
        "--preset", "kitti_sgm8_128", *SMALL,
        "--rig", "500,0.2",
        "--depth-out", str(depth), "--ply", str(ply),
    ])
    assert rc == 0
    z = np.load(depth)
    assert z.shape == (48, 80)
    assert (z[z > 0] > 0).all()
    header = ply.read_text().splitlines()[:8]
    assert header[0] == "ply"


def _expected_metrics(pair, cfg):
    """In-memory reference run for the on-disk round-trip tests."""
    from stereo_tpu.eval.metrics import evaluate_disparity
    from stereo_tpu.pipeline.pipeline import build_pipeline, host_postprocess

    fn = build_pipeline(cfg)
    res = fn(pair.left, pair.right)
    disp, valid = host_postprocess(res.disp, res.valid, cfg)
    return evaluate_disparity(disp, pair.gt_disp, pair.gt_valid, valid)


def test_cli_eval_kitti_tree_end_to_end(tmp_path, capsys):
    """`cli eval --kitti <dir>` over a real-format on-disk tree:
    synthetic pair + GT written as KITTI uint8/uint16 PNGs, then
    the loader->pipeline->metrics path must reproduce the in-memory run
    (GT quantization is 1/256 px, far below the bad-3 threshold)."""
    from PIL import Image

    from stereo_tpu.config import PRESETS
    from stereo_tpu.data.kitti import (
        read_kitti_disparity,
        write_kitti_disparity,
    )
    from stereo_tpu.data.synthetic import make_pair

    cfg = PRESETS["kitti_sgm8_128"].replace(num_disparities=16)
    root = tmp_path / "kitti"
    for sub in ("image_2", "image_3", "disp_noc_0"):
        (root / sub).mkdir(parents=True)
    pairs = {}
    for i in range(2):
        pair = make_pair((48, 80), max_disp=10, kind="shapes",
                         texture="cloud", seed=i)
        fid = f"{i:06d}_10"
        Image.fromarray(pair.left, mode="L").save(root / "image_2" / f"{fid}.png")
        Image.fromarray(pair.right, mode="L").save(root / "image_3" / f"{fid}.png")
        write_kitti_disparity(
            str(root / "disp_noc_0" / f"{fid}.png"), pair.gt_disp, pair.gt_valid
        )
        # quantized GT as the loader will see it
        gt_q, gtv_q = read_kitti_disparity(str(root / "disp_noc_0" / f"{fid}.png"))
        pairs[f"kitti-{fid}"] = pair._replace(gt_disp=gt_q, gt_valid=gtv_q)

    results = tmp_path / "res.jsonl"
    rc = main([
        "eval", "--preset", "kitti_sgm8_128", *SMALL,
        "--kitti", str(root), "--results", str(results),
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_pairs"] == 2

    recs = [json.loads(l) for l in results.read_text().splitlines()]
    assert {r["pair"] for r in recs} == set(pairs)
    for rec in recs:
        exp = _expected_metrics(pairs[rec["pair"]], cfg)
        assert abs(rec["bad3"] - exp["bad3"]) < 1e-6, rec
        assert abs(rec["epe"] - exp["epe"]) < 1e-4, rec
        assert rec["bad3"] < 0.05 and rec["density"] > 0.9, rec


def test_cli_eval_middlebury_tree_end_to_end(tmp_path, capsys):
    """`cli eval --middlebury <root>` over an on-disk 2014-layout scene
    (im0/im1.png + disp0.pfm): loader->pipeline->metrics must match the
    in-memory run bit-for-bit (PFM stores exact float32)."""
    from PIL import Image

    from stereo_tpu.config import PRESETS
    from stereo_tpu.data.middlebury import write_pfm
    from stereo_tpu.data.synthetic import make_pair

    cfg = PRESETS["middlebury_census_sgm4_64"].replace(num_disparities=16)
    pair = make_pair((48, 80), max_disp=10, kind="shapes",
                     texture="cloud", seed=3)
    scene = tmp_path / "mb" / "sceneA"
    scene.mkdir(parents=True)
    Image.fromarray(pair.left, mode="L").save(scene / "im0.png")
    Image.fromarray(pair.right, mode="L").save(scene / "im1.png")
    write_pfm(
        str(scene / "disp0.pfm"),
        np.where(pair.gt_valid, pair.gt_disp, np.inf).astype(np.float32),
    )

    results = tmp_path / "res.jsonl"
    rc = main([
        "eval", "--preset", "middlebury_census_sgm4_64", *SMALL,
        "--middlebury", str(tmp_path / "mb"), "--results", str(results),
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_pairs"] == 1

    rec = json.loads(results.read_text().splitlines()[0])
    assert rec["pair"] == "sceneA"
    exp = _expected_metrics(pair, cfg)
    assert abs(rec["bad3"] - exp["bad3"]) < 1e-6, rec
    assert abs(rec["epe"] - exp["epe"]) < 1e-6, rec
    assert rec["bad3"] < 0.05 and rec["density"] > 0.9, rec
