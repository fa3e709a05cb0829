"""Port parity: the command line (``python -m mort_tpu_torch.cli``) on the
CPU (``--device cpu``; without it the CLI runs on the card).  ``render``
writes the port's ``render_wavefront`` image bit for bit, and that image
matches the JAX package's ``cli.main`` of the same arguments by the image
rule; ``bench`` prints one JSON line with the JAX package's keys;
``--quick`` builds the JAX package's quick worlds."""

import argparse
import contextlib
import dataclasses
import importlib
import io
import json

import numpy as np
import pytest
import torch

from conftest import assert_images_close

from mort_tpu import cli as jcli
from mort_tpu_torch import cli
from mort_tpu_torch.render.wavefront import render_wavefront
from mort_tpu_torch.scene import scenes as sc

ARGS = ["--width", "16", "--spp", "4", "--depth", "4"]


def test_render_npz_equals_render_wavefront_and_jax(tmp_path, capsys):
    out = str(tmp_path / "port.npz")
    rec = cli.main(["render", "5", *ARGS, "--device", "cpu", "--out", out])
    lines = capsys.readouterr()
    assert lines.out.strip() == out
    assert lines.err.startswith("scene 5: 16x16 @ 4spp depth 4 (0 spheres, "
                                "5 quads, 0 media, 0 lights)")
    assert "rendered in" in lines.err
    assert rec["paths"] == 16 * 16 * 4 and rec["out"] == out
    got = np.load(out)["image"]
    world, cam = sc.build_scene(5)
    data, meta = world.compile()
    cam = cam.replace(image_width=16, image_height=16, sqrt_spp=2,
                      bounce_limit=4)
    want = render_wavefront(data, meta, cam, "cpu", seed=69420).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)

    jout = str(tmp_path / "jax.npz")
    jcli.main(["render", "5", *ARGS, "--out", jout])
    assert_images_close(got, np.load(jout)["image"])


def test_render_png(tmp_path, capsys):
    out = str(tmp_path / "port.png")
    cli.main(["render", "5", "--width", "8", "--spp", "1", "--depth", "2",
              "--device", "cpu", "--out", out, "--seed", "3"])
    from PIL import Image
    assert Image.open(out).size == (8, 8)


class _Done:
    def block_until_ready(self):
        return self


def test_bench_prints_one_json_line_with_jax_keys(capsys, monkeypatch):
    small = ["5", "--width", "8", "--spp", "1", "--depth", "2",
             "--frames", "1"]
    rec = cli.main(["bench", *small, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    # the JAX package's record, its render stubbed (one JAX render a file)
    jwf = importlib.import_module("mort_tpu.render.wavefront")
    monkeypatch.setattr(jwf, "render_wavefront", lambda *a, **k: _Done())
    jcli.main(["bench", *small])
    jrec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rec) == list(jrec)
    for k in ("scene", "width", "height", "spp", "depth"):
        assert rec[k] == jrec[k]
    assert rec["wall_s"] > 0 and rec["paths_per_s"] > 0


@pytest.mark.parametrize("scene", [1, 8, 9])
def test_quick_builds_the_quick_worlds(scene):
    ns = argparse.Namespace(scene=scene, width=None, spp=None, depth=None,
                            quick=True)
    data, meta, cam = cli._build(ns)
    jdata, jmeta, jcam = jcli._build(ns)
    assert (meta.n_spheres, meta.n_quads, len(meta.aab)) == (
        jmeta.n_spheres, jmeta.n_quads, len(jmeta.aab))
    assert meta.n_spheres + meta.n_quads < 1000
    for f in dataclasses.fields(jcam):
        np.testing.assert_array_equal(np.asarray(getattr(cam, f.name)),
                                      np.asarray(getattr(jcam, f.name)))
    np.testing.assert_array_equal(data.sph_center.numpy(),
                                  np.asarray(jdata.sph_center))


def test_overrides_and_bad_scene(capsys):
    ns = argparse.Namespace(scene=6, width=100, spp=10, depth=7,
                            quick=False)
    _, _, cam = cli._build(ns)
    _, _, jcam = jcli._build(ns)
    assert (cam.image_width, cam.image_height, cam.sqrt_spp,
            cam.bounce_limit) == (jcam.image_width, jcam.image_height,
                                  jcam.sqrt_spp, jcam.bounce_limit)
    with pytest.raises(SystemExit):
        cli.main(["render", "11", "--device", "cpu"])


def test_default_device_is_the_card():
    """Without --device the CLI asks for the card: here, with none, it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["render", "5", *ARGS])
