"""The port's BASELINE config #5 tool (``python -m mort_tpu_torch.config5``)
on the CPU: the one-device mode at a tiny camera on final_scene's quick
world (the card runs 1920x1080), its record keys equal to the committed
``CONFIG5.json``'s, and the ``--mesh`` mode's elastic resume on 2 -> 1
gloo ranks.  Nothing is written outside the test's directory."""

import json
import os
from pathlib import Path

import pytest
import torch

from mort_tpu_torch import config5

REPO = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--quick", "--width", "16", "--height", "9",
        "--spp", "1", "--depth", "3", "--grad-width", "8",
        "--grad-height", "4"]


def _repo_files():
    out = REPO / "chiprun_out"
    return set(os.listdir(REPO)), set(os.listdir(out)) if out.exists() \
        else set()


def test_device_mode_on_the_cpu(tmp_path, monkeypatch, capsys):
    before = _repo_files()
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rec" / "config5.json"
    rec = config5.main(TINY + ["--out", str(out)])
    assert _repo_files() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rec"]
    assert json.loads(out.read_text()) == rec
    want = json.loads((REPO / "CONFIG5.json").read_text())
    assert set(rec) == set(want) | {"card", "grad_non_finite"}
    assert (rec["width"], rec["height"], rec["spp"], rec["depth"]) == \
        (16, 9, 1, 3)
    assert rec["image_finite"] is True and rec["card"] == "cpu"
    assert 0 < rec["lane_occupancy"] <= 1 and rec["grad_loss"] > 0
    err = capsys.readouterr().err
    assert "non-finite gradient entries" in err


def test_warmup_span_and_the_default_depth(tmp_path):
    """``warmup_tasks`` warms up on a span; the depth is final_scene's."""
    rec = config5.run_device("cpu", 8, 4, 1, None, warmup_tasks=16,
                             grad_width=4, grad_height=2, quick=True)
    assert rec["depth"] == 40 and rec["image_finite"]


def test_mesh_mode_resumes_bit_identical(tmp_path):
    before = _repo_files()
    rec = config5.run_mesh(2, 1, workdir=tmp_path)
    assert _repo_files() == before
    assert list(tmp_path.iterdir()) == []
    assert rec["resume_bit_identical"] is True
    assert rec["ranks"] == [2, 1] and rec["all_reduce"] == 1
    assert rec["n_leaves"] == 10 and rec["loss"] > 0


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config5.main(["--width", "8", "--height", "4"])
