"""Port parity: scene compilation, the carry-across helpers and camera rays.

The port's ``World.compile()`` must produce exactly the JAX package's arrays
(the builder is the same numpy code), and ``get_rays_soa`` the same rays.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mort_tpu.camera import derive_basis as j_basis, get_rays_soa as j_rays
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch.camera import (
    camera_from_numpy, derive_basis as t_basis, get_rays_soa as t_rays,
)
from mort_tpu_torch.scene import scenes as tsc
from mort_tpu_torch.scene.build import scene_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_scene_equal(tdata, tmeta, jdata, jmeta):
    for name, want in _fields(jdata).items():
        got = getattr(tdata, name)
        if isinstance(want, tuple):
            assert len(got) == len(want), name
            pairs = zip(got, want)
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            w = np.asarray(w)
            assert g.shape == w.shape, name
            # values exactly equal; int32 stands in for uint32 in
            # images_packed (values < 2^24)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)


@pytest.mark.parametrize("idx", list(range(1, 11)))
def test_compiled_scene_equals_jax(idx):
    jdata, jmeta = jsc.build_scene(idx)[0].compile()
    tdata, tmeta = tsc.build_scene(idx)[0].compile()
    _assert_scene_equal(tdata, tmeta, jdata, jmeta)


def test_scene_from_numpy_round_trip():
    """JAX leaves -> port, and the port's own leaves -> port again."""
    jdata, jmeta = jsc.final_scene(quick=True)[0].compile()
    tdata, tmeta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    _assert_scene_equal(tdata, tmeta, jdata, jmeta)
    again = scene_from_numpy(
        {k: (tuple(x.numpy() for x in v) if isinstance(v, tuple)
             else v.numpy()) for k, v in _fields(tdata).items()},
        dataclasses.asdict(tmeta))
    _assert_scene_equal(again[0], again[1], jdata, jmeta)
    moved = tdata.to("cpu")
    assert moved.sph_center.device.type == "cpu"


def _ray_pair(jcam, n=4096, seed=69420, no_defocus=False):
    tcam = camera_from_numpy(_fields(jcam))
    rs = np.random.RandomState(1)
    W, H = jcam.image_width, jcam.image_height
    pix = rs.randint(0, W * H, n).astype(np.int64)
    smp = rs.randint(0, jcam.sqrt_spp ** 2, n).astype(np.int64)
    jo, jd, jt = j_rays(jcam, j_basis(jcam), jnp.uint32(seed),
                        jnp.asarray(pix, jnp.int32),
                        jnp.asarray(smp, jnp.int32), no_defocus=no_defocus)
    to, td, tt = t_rays(tcam, t_basis(tcam), seed, torch.from_numpy(pix),
                        torch.from_numpy(smp), no_defocus=no_defocus)
    return (jo, jd, jt), (to, td, tt)


def test_rays_match_jax_scene1():
    jcam = jsc.random_spheres()[1].replace(image_width=96, image_height=54)
    (jo, jd, jt), (to, td, tt) = _ray_pair(jcam, no_defocus=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # mul and add only after the basis (whose tan/sqrt may differ by an
    # ulp between XLA and torch): a few float32 ulps of the coordinates
    for g, w in zip(list(to) + list(td), list(jo) + list(jd)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_rays_match_jax_defocus(three_sphere_scene):
    _, _, jcam = three_sphere_scene
    (jo, jd, jt), (to, td, tt) = _ray_pair(jcam)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the defocus disk goes through sin/cos, which may differ by an ulp
    for g, w in zip(list(to) + list(td), list(jo) + list(jd)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import mort_tpu_torch, mort_tpu_torch.device, mort_tpu_torch.rng\n"
        "import mort_tpu_torch.camera, mort_tpu_torch._build\n"
        "import mort_tpu_torch.scene.types, mort_tpu_torch.scene.build\n"
        "import mort_tpu_torch.scene.scenes, mort_tpu_torch.render.vec\n"
        "import mort_tpu_torch.render.intersect\n"
        "import mort_tpu_torch.render.primtable\n"
        "import mort_tpu_torch.render.textures\n"
        "import mort_tpu_torch.render.shade\n"
        "import mort_tpu_torch.render.hitshade\n"
        "import mort_tpu_torch.render.closest_hit\n"
        "import mort_tpu_torch.render.wavefront\n"
        "import mort_tpu_torch.render.integrator\n"
        "import mort_tpu_torch.render.renderer\n"
        "import mort_tpu_torch.parallel.sharding\n"
        "bad =[m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mort_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
