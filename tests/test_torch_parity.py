"""The port's parity gate (``mort_tpu_torch.parity``) and its committed JAX
reference images, on the CPU.

``mort_tpu_torch/data/parity_refs.npz`` holds the JAX package's CPU
lockstep ``render`` of each reference key of ``tools/tpu_parity.py`` (the
card has no jax).  The tests hold the file to today's JAX sources (the
digest of ``tools/tpu_parity.py::_cache_path``) and to a fresh JAX render
of scene 2, and the gate to its rules: it passes the port's CPU wavefront
against a JAX lockstep image and fails that image darkened (DEVIATIONS.md
section 6) or flipped.

    python tests/test_torch_parity.py --regen    # remake the file (jax)
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mort_tpu_torch import parity  # noqa: E402

SMALL_W, SMALL_SQRT_SPP, SMALL_DEPTH = 32, 2, 4


def _tool():
    from tools import tpu_parity
    return tpu_parity


def source_digest() -> str:
    """sha256 of the reference keys, the config and ``mort_tpu/**/*.py``,
    walked and fed exactly as ``tools/tpu_parity.py::_cache_path`` does."""
    tp = _tool()
    h = hashlib.sha256()
    keys = tuple(sorted({tp._ref_key(c) for c in tp.CONFIGS}))
    h.update(repr((keys, tp.WIDTH, tp.SPP, tp.SEED_A)).encode())
    for dirpath, dirnames, filenames in sorted(os.walk(REPO / "mort_tpu")):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                h.update(fn.encode())
                with open(os.path.join(dirpath, fn), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def jax_reference(key: str) -> np.ndarray:
    """One reference image, made as ``render_cpu_refs`` makes it."""
    from mort_tpu.render.renderer import render
    from mort_tpu.scene import scenes as jsc

    tp = _tool()
    idx, depth = key.split("@d")
    world, cam = jsc.build_scene(int(idx))
    data, meta = world.compile()
    return np.asarray(render(data, meta, tp._cam_for(cam, int(depth)),
                             seed=tp.SEED_A), np.float32)


def regen(path=parity.REFS) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()
    import time

    tp = _tool()
    keys = sorted({tp._ref_key(c) for c in tp.CONFIGS})
    out = {}
    for key in keys:
        t0 = time.perf_counter()
        out[key] = jax_reference(key)
        print(f"  jax cpu ref {key}: {out[key].shape} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    meta = {"width": tp.WIDTH, "spp": tp.SPP, "seed": tp.SEED_A,
            "depth": {k: int(k.split("@d")[1]) for k in keys},
            "digest": source_digest(),
            "earthmap": parity.earthmap_source(),
            "made_by": "mort_tpu.render.renderer.render on the CPU "
                       "(tools/tpu_parity.py render_cpu_refs)"}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, meta=np.array(json.dumps(meta)), **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_configs_and_rules_are_the_tools():
    tp = _tool()
    assert parity.CONFIGS == tp.CONFIGS
    assert [parity.cfg_label(c) for c in parity.CONFIGS] == \
        [tp._cfg_label(c) for c in tp.CONFIGS]
    assert [parity.ref_key(c) for c in parity.CONFIGS] == \
        [tp._ref_key(c) for c in tp.CONFIGS]
    for name in ("WIDTH", "SPP", "DEPTH", "SEED_A", "SEED_B", "NOISE_FACTOR",
                 "NOISE_ABS", "MEAN_RTOL", "MEAN_ATOL"):
        assert getattr(parity, name) == getattr(tp, name), name


def test_committed_references_match_the_jax_sources():
    tp = _tool()
    images, meta = parity.load_refs()
    keys = sorted({tp._ref_key(c) for c in tp.CONFIGS})
    assert sorted(images) == keys and len(keys) == 11
    from mort_tpu_torch.scene import scenes as tsc
    for key, img in images.items():
        idx, depth = key.split("@d")
        cam = tsc.build_scene(int(idx))[1]
        h = max(1, int(tp.WIDTH * cam.image_height / cam.image_width))
        assert img.shape == (h, tp.WIDTH, 3) and img.dtype == np.float32, key
        assert np.isfinite(img).all(), key
        assert meta["depth"][key] == int(depth)
    assert (meta["width"], meta["spp"], meta["seed"]) == \
        (tp.WIDTH, tp.SPP, tp.SEED_A)
    digest = source_digest()
    assert meta["digest"] == digest, (
        "mort_tpu's sources changed since the references were made: "
        "python tests/test_torch_parity.py --regen")
    assert os.path.basename(tp.CACHE) == \
        f"mort_tpu_parity_ref_{digest[:16]}.npz"
    assert meta["earthmap"] == parity.earthmap_source()


def test_scene2_reference_regenerates():
    from conftest import assert_images_close

    want = parity.load_refs()[0]["2@d10"]
    got = jax_reference("2@d10")
    assert_images_close(got, want)
    np.testing.assert_allclose(got.mean(axis=(0, 1)),
                               want.mean(axis=(0, 1)), atol=1e-3)


@pytest.fixture(scope="module")
def small_images():
    """Scene 1 at 32 px, 4 spp, depth 4: the port's CPU wavefront at seeds
    A and B, and the JAX lockstep image at seed A."""
    from mort_tpu.render.renderer import render
    from mort_tpu.scene import scenes as jsc
    from mort_tpu_torch.render.wavefront import render_wavefront
    from mort_tpu_torch.scene import scenes as tsc

    def small(cam):
        h = max(1, int(SMALL_W * cam.image_height / cam.image_width))
        return cam.replace(image_width=SMALL_W, image_height=h,
                           sqrt_spp=SMALL_SQRT_SPP, bounce_limit=SMALL_DEPTH)

    world, cam = tsc.build_scene(1)
    data, meta = world.compile()
    a, b = (render_wavefront(data, meta, small(cam), "cpu", seed=s).numpy()
            for s in (parity.SEED_A, parity.SEED_B))
    jworld, jcam = jsc.build_scene(1)
    jdata, jmeta = jworld.compile()
    want = np.asarray(render(jdata, jmeta, small(jcam), seed=parity.SEED_A))
    return a, b, want


def test_gate_passes_the_port_against_jax(small_images):
    a, b, want = small_images
    g = parity.gate(a, b, want)
    assert g["ok"] and g["ok_noise"] and g["ok_mean"], g
    assert g["cross"] < 0.2 * g["noise"], g


@pytest.mark.parametrize("fault", ["darkened", "flipped"])
def test_gate_fails_a_wrong_image(small_images, fault):
    a, b, want = small_images
    bad = want * np.float32(0.72) if fault == "darkened" else want[::-1]
    g = parity.gate(a, b, bad)
    assert not g["ok"], g
    if fault == "darkened":
        assert not g["ok_mean"], g
    else:
        assert not g["ok_noise"], g


def test_gate_fails_a_non_finite_image(small_images):
    a, b, want = small_images
    a = a.copy()
    a[0, 0, 0] = np.nan
    assert not parity.gate(a, b, want)["ok"]


def test_tool_runs_on_the_cpu_and_writes_only_out(tmp_path, monkeypatch):
    """``main`` on the CPU for one config against a references file of the
    port's own image: it writes its record to ``--out`` only, with
    TPU_PARITY.json's keys, and exits 0; against a darkened file, 1."""
    from mort_tpu_torch.render.wavefront import render_wavefront
    from mort_tpu_torch.scene import scenes as tsc

    monkeypatch.setattr(parity, "WIDTH", 16)
    monkeypatch.setattr(parity, "SPP", 4)
    world, cam = tsc.build_scene(2)
    data, meta = world.compile()
    img = render_wavefront(data, meta, parity.cam_for(cam), "cpu",
                           seed=parity.SEED_A).numpy()
    meta_rec = {"seed": parity.SEED_A, "digest": "x", "earthmap": "procedural"}
    for name, ref, rc in (("good", img, 0), ("dark", img * 0.72, 1)):
        refs = tmp_path / f"{name}.npz"
        np.savez(refs, meta=np.array(json.dumps(meta_rec)), **{"2@d10": ref})
        out = tmp_path / name / "parity.json"
        before = set(os.listdir(REPO))
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(parity, "REFS", refs)
        assert parity.main(["--device", "cpu", "--only", "2", "--out",
                            str(out)]) == rc
        assert set(os.listdir(REPO)) == before
        rec = json.loads(out.read_text())
        want_keys = json.loads((REPO / "TPU_PARITY.json").read_text())
        assert set(rec["scenes"][0]) == set(want_keys["scenes"][0])
        assert set(rec) >= set(want_keys)
        assert rec["backend"] == "cpu" and rec["ok"] is (rc == 0)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["dark", "dark.npz", "good", "good.npz"]


def test_tool_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.run()


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen()
