"""The port's schedule sweep (``python -m mort_tpu_torch.tune_wavefront``)
on the CPU at a tiny camera: the JAX tool's seven configs, one line each,
at every pool asked for; every config's image is the same integral, so the
runs agree on the path count; it writes no file."""

import os
from pathlib import Path

import pytest
import torch

from mort_tpu_torch import tune_wavefront as tw

REPO = Path(__file__).resolve().parent.parent


def test_configs_are_the_jax_tools():
    src = (REPO / "tools" / "tune_wavefront.py").read_text()
    for spt, window, span in tw.CONFIGS:
        assert f"({spt}, {window}, {span})" in src
    assert len(tw.CONFIGS) == 7


def test_sweep_on_the_cpu(tmp_path, monkeypatch, capsys):
    before = set(os.listdir(REPO))
    monkeypatch.chdir(tmp_path)
    recs = tw.main(["5", "--device", "cpu", "--width", "16", "--spp", "4",
                    "--depth", "3", "--pools", "1024", "2048"])
    assert set(os.listdir(REPO)) == before and list(tmp_path.iterdir()) == []
    assert len(recs) == 14
    assert [(r["spt"], r["window"], r["span_m"]) for r in recs[:7]] == \
        list(tw.CONFIGS)
    assert {r["pool"] for r in recs} == {1024, 2048}
    for r in recs:
        assert r["seconds"] > 0 and r["warmup_s"] > 0
        assert 0 < r["occupancy"] <= 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("scene 5: 16x16 @ 4spp depth 3")
    assert len(lines) == 15 and all("paths/s occ" in x for x in lines[1:])


def test_default_spp_is_cut_to_49():
    recs = tw.sweep(1, "cpu", width=8, depth=1, configs=tw.CONFIGS[:1],
                    log=lambda m: None)
    assert recs[0]["paths_per_s"] > 0
    # scene 1's 100 spp cut to 7^2, as the JAX tool cuts it
    assert tw.MAX_SQRT_SPP == 7


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.main(["5"])
