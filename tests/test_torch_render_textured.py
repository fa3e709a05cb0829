"""Port parity, whole images: the sphere scenes with textures — checker
(2), image (3), Perlin noise (4) and the BVH-list spheres (10) — at the
golden config (48 px, 4 spp, depth 8), the port's wavefront on the CPU
against the JAX package's XLA-intersector wavefront, by the image rule of
conftest.py.
"""

import functools

import numpy as np
import pytest

from conftest import assert_images_close
from test_torch_wavefront import GOLDEN_SEED, _golden_camera

from mort_tpu.render.wavefront import render_wavefront as j_render
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.render.wavefront import render_wavefront
from mort_tpu_torch.scene import scenes as tsc


@functools.lru_cache(maxsize=None)
def _jax_image(idx, camera):
    """The JAX package's XLA-intersector image of scene ``idx``, computed
    once per process for each (scene, camera) (several port renders are
    held against the same one)."""
    jworld, jcam = jsc.build_scene(idx)
    jdata, jmeta = jworld.compile()
    want = np.asarray(j_render(jdata, jmeta, camera(jcam), seed=GOLDEN_SEED,
                               use_pallas=False))
    want.setflags(write=False)
    return want


def render_both(idx, camera=_golden_camera, **port_kw):
    """The JAX package's and the port's image of scene ``idx``; each
    package builds the scene itself (their arrays are equal:
    test_torch_scene.py)."""
    want = _jax_image(idx, camera)
    tworld, tcam = tsc.build_scene(idx)
    data, meta = tworld.compile()
    got = render_wavefront(data, meta, camera(tcam), "cpu", seed=GOLDEN_SEED,
                           **port_kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return got, want


@pytest.mark.parametrize("idx", [2, 3, 4, 10])
def test_golden_config_matches_jax(idx):
    got, want = render_both(idx)
    assert want.mean() > 0.01
    assert_images_close(got, want, msg=f"scene {idx} port vs jax")
