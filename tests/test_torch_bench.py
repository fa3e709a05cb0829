"""The port's bench entry (``python -m mort_tpu_torch.bench``) on the CPU
at a tiny camera: ``bench.py``'s records and summary line, read from the
repo's files (``bench.py``'s keys and ``BENCH_SCENES.json``), ``--all``
writing only ``--out``, and no silent CPU run without ``--device``."""

import ast
import json
import os
from pathlib import Path

import pytest
import torch

from mort_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--width", "16", "--spp", "1", "--depth", "2"]


def _bench_py_line_keys():
    """The keys of the JSON objects that ``bench.py`` prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
    return keys


def _repo_files():
    out = REPO / "chiprun_out"
    return set(os.listdir(REPO)), set(os.listdir(out)) if out.exists() \
        else set()


def test_scene_record_and_summary_line(tmp_path, monkeypatch, capsys):
    before = _repo_files()
    monkeypatch.chdir(tmp_path)
    recs = bench.main(TINY + ["--scene", "5", "--frames", "2"])
    assert _repo_files() == before and list(tmp_path.iterdir()) == []
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == _bench_py_line_keys() == {
        "metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "scene5_paths_per_s"
    assert line["unit"] == "paths/s/chip"
    rec = recs[-1]
    want = json.loads((REPO / "BENCH_SCENES.json").read_text())
    assert set(rec) == set(want[0]) | {"card"}
    assert rec["card"] == "cpu" and rec["frames"] == 2
    assert (rec["width"], rec["spp"], rec["depth"]) == (16, 1, 2)
    assert line["value"] == rec["paths_per_s"]
    assert rec["vs_baseline"] == round(
        rec["paths_per_s"] / bench.BASELINE_PATHS_PER_S, 4)


def test_grad_record(capsys):
    (rec,) = bench.main(TINY + ["--grad"])
    want = json.loads((REPO / "BENCH_SCENES.json").read_text())[-1]
    assert set(rec) == set(want) | {"card"}
    assert rec["mode"] == "grad_step" and rec["loss"] > 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "scene1_grad_paths_per_s"
    assert line["value"] == rec["grad_paths_per_s"]


def test_scene1_default_rides_the_grad_step():
    recs = bench.main(TINY + ["--frames", "1"])
    assert [r.get("mode") for r in recs] == ["grad_step", None]
    assert recs[-1]["scene"] == 1


def test_all_writes_only_out(tmp_path, monkeypatch):
    """``--all`` at the tiny camera, scenes cut to 1 frame each: the records
    of ten scenes and the train step land in ``--out`` only."""
    monkeypatch.setattr(bench, "WARMUP_TASKS", 64)
    before = _repo_files()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "all" / "bench.json"
    bench.main(TINY + ["--all", "--frames", "1", "--out", str(out)])
    assert _repo_files() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["all"]
    recs = json.loads(out.read_text())
    assert [r["scene"] for r in recs] == list(range(1, 11)) + [1]
    assert recs[-1]["mode"] == "grad_step"


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--scene", "5"])
