"""Port parity: the public names of the JAX package's API that the port
mirrors, each against the JAX function on the same seeded numpy inputs.

``to_u8_np``, ``camera.get_rays``, ``rng.philox4x32_np``/``uniform4_np``,
``vec.rotate_around`` (JAX ``math3``), ``intersect.Hit``/``finalize_hit``/
``intersect_world``/``UV_CLAMP``, ``shade.INV_4PI`` and
``render_wavefront(chunk=)``.  torch's CPU float32 ``sqrt`` is 1 ulp off on
~0.6% of inputs (ROADMAP C3), so rays, rotations and hit distances are held
within a few ulps; integers and Philox words are held bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mort_tpu
import mort_tpu_torch
from mort_tpu import camera as jcamera, rng as jrng
from mort_tpu.render import intersect as jint, math3 as jm3, shade as jshade
from mort_tpu.scene import scenes as jsc
from mort_tpu_torch import camera as tcamera, rng as trng
from mort_tpu_torch.render import intersect as tint, shade as tshade
from mort_tpu_torch.render import vec as tvec
from mort_tpu_torch.render.wavefront import render_wavefront
from mort_tpu_torch.scene import scenes as tsc
from mort_tpu_torch.scene.build import scene_from_numpy

SEED = 69420


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_ulps(got, want, n, scale=None, err_msg=""):
    """|got - want| <= n float32 ulps of max(|want|, scale) elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, err_msg
    ref = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    tol = n * np.spacing(ref.astype(np.float32))
    bad = ~(np.abs(got.astype(np.float64) - want) <= tol)
    assert not bad.any(), (
        f"{err_msg}: {bad.sum()} of {bad.size} beyond {n} ulps; worst "
        f"{np.abs(got.astype(np.float64) - want)[bad].max():.3e}")


def test_to_u8_np_is_exported_and_matches_jax():
    rs = np.random.RandomState(0)
    img = rs.uniform(-0.2, 1.5, (9, 7, 3)).astype(np.float32)
    got = mort_tpu_torch.to_u8_np(img)
    assert "to_u8_np" in mort_tpu_torch.__all__
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, mort_tpu.to_u8_np(img))
    np.testing.assert_array_equal(
        mort_tpu_torch.to_u8_np(torch.from_numpy(img)), got)


def test_philox_np_bit_equal_to_jax_and_to_torch():
    rs = np.random.RandomState(1)
    c = [rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
         for _ in range(4)]
    k0, k1 = 0xDEADBEEF, trng.SEED2
    got = trng.philox4x32_np(*c, k0, k1)
    want = jrng.philox4x32_np(*c, k0, k1)
    ref = trng.philox4x32(*(torch.from_numpy(x.astype(np.int64)) for x in c),
                          k0, k1)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g.astype(np.int64), r.numpy())


def test_uniform4_np_bit_equal_to_jax_and_to_torch():
    rs = np.random.RandomState(2)
    pix = rs.randint(0, 1 << 20, 4096).astype(np.uint32)
    smp = rs.randint(0, 1024, 4096).astype(np.uint32)
    got = trng.uniform4_np(SEED, pix, smp, 3, trng.SLOT_MEDIUM0)
    want = jrng.uniform4_np(SEED, pix, smp, 3, jrng.SLOT_MEDIUM0)
    ref = trng.uniform4(SEED, torch.from_numpy(pix.astype(np.int64)),
                        torch.from_numpy(smp.astype(np.int64)), 3,
                        trng.SLOT_MEDIUM0)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r.numpy())


@pytest.mark.parametrize("scene", [1, 6])
def test_get_rays_matches_jax(scene):
    """AoS rays of scene 1 (defocus on) and scene 6 (a pinhole)."""
    jcam = jsc.build_scene(scene)[1].replace(image_width=96, image_height=54)
    tcam = tcamera.camera_from_numpy(_fields(jcam))
    rs = np.random.RandomState(3)
    pix = rs.randint(0, 96 * 54, 4096)
    smp = rs.randint(0, jcam.sqrt_spp ** 2, 4096)
    jo, jd, jt = jcamera.get_rays(jcam, jcamera.derive_basis(jcam),
                                  jnp.uint32(SEED), jnp.asarray(pix, jnp.int32),
                                  jnp.asarray(smp, jnp.int32))
    to, td, tt = tcamera.get_rays(tcam, tcamera.derive_basis(tcam), SEED,
                                  torch.from_numpy(pix),
                                  torch.from_numpy(smp))
    assert to.shape == td.shape == (4096, 3) and tt.shape == (4096,)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the basis's tan/sqrt and the disk's sin/cos may differ by an ulp:
    # a few ulps of the camera's coordinate scale
    scale = float(np.abs(np.asarray(jcam.lookfrom)).max())
    assert_ulps(to.numpy(), jo, 8, scale, "origins")
    assert_ulps(td.numpy(), jd, 8, scale, "directions")


def test_rotate_around_matches_jax():
    rs = np.random.RandomState(4)
    v = rs.randn(512, 3).astype(np.float32)
    axis = rs.randn(512, 3).astype(np.float32)
    theta = rs.uniform(-3, 3, 512).astype(np.float32)
    got = tvec.rotate_around(torch.from_numpy(v), torch.from_numpy(axis),
                             torch.from_numpy(theta))
    want = np.asarray(jm3.rotate_around(jnp.asarray(v), jnp.asarray(axis),
                                        jnp.asarray(theta)))
    assert got.dtype == torch.float32
    scale = np.linalg.norm(v, axis=1, keepdims=True)
    assert_ulps(got.numpy(), want, 8, scale, "rotate_around")
    # one scalar angle broadcasts
    one = tvec.rotate_around(torch.from_numpy(v), torch.from_numpy(axis), 0.3)
    want1 = np.asarray(jm3.rotate_around(jnp.asarray(v), jnp.asarray(axis),
                                         0.3))
    assert_ulps(one.numpy(), want1, 8, scale, "rotate_around scalar")


def test_constants_and_hit_fields():
    assert tint.UV_CLAMP == jint.UV_CLAMP
    assert tshade.INV_4PI == jshade.INV_4PI
    assert [f.name for f in dataclasses.fields(tint.Hit)] == \
        [f.name for f in dataclasses.fields(jint.Hit)]


@pytest.fixture(scope="module")
def scene7_rays():
    """Scene 7 (two constant media in the Cornell box) in both packages and
    4096 camera and bounce rays through it."""
    jworld, jcam = jsc.build_scene(7)
    jdata, jmeta = jworld.compile()
    tdata, tmeta = scene_from_numpy(_fields(jdata), _fields(jmeta))
    rs = np.random.RandomState(5)
    R = 4096
    cam = tsc.build_scene(7)[1]
    eye = cam.lookfrom.numpy()
    ro = np.repeat(eye[None], R, 0).astype(np.float32)
    target = rs.uniform([0, 0, 0], [555, 555, 555], (R, 3))
    rd = (target - ro).astype(np.float32)
    # half the rays start inside the box: bounce rays through the media
    inner = rs.uniform([50, 50, 50], [505, 505, 505], (R // 2, 3))
    ro[R // 2:] = inner.astype(np.float32)
    rd[R // 2:] = rs.randn(R // 2, 3).astype(np.float32)
    tme = rs.uniform(0, 1, R).astype(np.float32)
    pix = rs.randint(0, 600 * 600, R)
    smp = rs.randint(0, 64, R)
    bounce = 2
    return (jdata, jmeta, tdata, tmeta, ro, rd, tme, pix, smp, bounce)


def _check_hit(got, want, t_ulps):
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    assert got.mat.dtype == torch.int32
    assert_ulps(got.t.numpy(), want.t, t_ulps, 1.0, "t")
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.front_face.numpy()[hit],
                                  np.asarray(want.front_face)[hit])
    for name in ("p", "normal", "u", "v"):
        assert_ulps(getattr(got, name).numpy(), getattr(want, name),
                    max(t_ulps, 1), 1.0, name)


def test_intersect_world_matches_jax_on_scene7_media(scene7_rays):
    jdata, jmeta, tdata, tmeta, ro, rd, tme, pix, smp, bounce = scene7_rays
    jqf, tqf = jint.quad_frames(jdata), tint.quad_frames(tdata)
    want = jint.intersect_world(
        jdata, jmeta, jqf, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), jnp.uint32(SEED), jnp.asarray(pix, jnp.int32),
        jnp.asarray(smp, jnp.int32), bounce)
    got = tint.intersect_world(
        tdata, tmeta, tqf, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(tme), SEED, torch.from_numpy(pix),
        torch.from_numpy(smp), bounce)
    assert isinstance(got, tint.Hit)
    # the media draw really runs: both media win some rays, quads others
    mats = {int(m) for m in np.asarray(want.mat)[np.asarray(want.hit)]}
    med_rows = {med.mat_row for med in jmeta.media}
    assert med_rows <= mats and len(mats - med_rows) >= 3, (mats, med_rows)
    _check_hit(got, want, 4)

    # kind and idx exact: intersect_world is finalize_hit of the closest
    # hit and the media draw, whose (t, kind, idx) are JAX's intersect_best
    from mort_tpu_torch.render import closest_hit as ch
    from mort_tpu_torch.render.primtable import build_prim_table
    jt, jk, ji = jint.intersect_best(
        jdata, jmeta, jqf, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), jnp.uint32(SEED), jnp.asarray(pix, jnp.int32),
        jnp.asarray(smp, jnp.int32), bounce)
    packed = ch.pack_scene(tdata, tmeta, tqf,
                           build_prim_table(tdata, tmeta, tqf)[0])
    ro_v, rd_v = (tvec.V3.from_rows(torch.from_numpy(x)) for x in (ro, rd))
    bt, bk, bi, _ = ch.closest_hit(packed, ro_v, rd_v, torch.from_numpy(tme))
    bt, bk, bi = tint.media_pass(tdata, tmeta, tqf, ro_v, rd_v, SEED,
                                 torch.from_numpy(pix), torch.from_numpy(smp),
                                 bounce, tint.T_MIN, bt, bk, bi)
    np.testing.assert_array_equal(bk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
    assert_ulps(np.where(np.isfinite(jt), bt.numpy(), 0),
                np.where(np.isfinite(jt), jt, 0), 4, 1.0, "best t")
    again = tint.finalize_hit(tdata, tmeta, tqf, torch.from_numpy(ro),
                              torch.from_numpy(rd), torch.from_numpy(tme),
                              bt, bk, bi)
    for f in dataclasses.fields(tint.Hit):
        assert torch.equal(getattr(again, f.name), getattr(got, f.name))


def test_finalize_hit_matches_jax(scene7_rays):
    """The gather alone, on the JAX package's own closest hit."""
    jdata, jmeta, tdata, tmeta, ro, rd, tme, pix, smp, bounce = scene7_rays
    jqf, tqf = jint.quad_frames(jdata), tint.quad_frames(tdata)
    bt, bk, bi = jint.intersect_best(
        jdata, jmeta, jqf, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(tme), jnp.uint32(SEED), jnp.asarray(pix, jnp.int32),
        jnp.asarray(smp, jnp.int32), bounce)
    want = jint.finalize_hit(jdata, jmeta, jqf, jnp.asarray(ro),
                             jnp.asarray(rd), jnp.asarray(tme), bt, bk, bi)
    got = tint.finalize_hit(
        tdata, tmeta, tqf, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(tme), *(torch.tensor(np.asarray(x))
                                 for x in (bt, bk, bi)))
    _check_hit(got, want, 0)


def test_intersect_world_sphere_ties():
    """Two coincident spheres and a quad through their centre plane: the
    earlier sphere row wins the exact tie, and the sphere beats the quad."""
    w = mort_tpu_torch.World()
    m0 = w.lambertian(w.solid_color([1, 0, 0]))
    m1 = w.lambertian(w.solid_color([0, 1, 0]))
    m2 = w.lambertian(w.solid_color([0, 0, 1]))
    w.sphere([0, 0, -2], 0.5, m0)
    w.sphere([0, 0, -2], 0.5, m1)
    # the quad's plane z = -1.5 touches the spheres' near pole exactly
    w.quad([-1, -1, -1.5], [2, 0, 0], [0, 2, 0], m2)
    data, meta = w.compile()
    ro = torch.zeros((3, 3))
    rd = torch.tensor([[0.0, 0.0, -1.0], [0.3, 0.0, -1.0], [0.0, 3.0, -1.0]])
    hit = tint.intersect_world(data, meta, tint.quad_frames(data), ro, rd,
                               torch.zeros(3), SEED, torch.arange(3),
                               torch.zeros(3, dtype=torch.int64), 0)
    mats = hit.mat.tolist()
    assert mats[0] == data.sph_mat[0].item(), mats   # tie: first sphere,
    assert hit.t[0].item() == 1.5                    # not the quad
    assert mats[1] == data.quad_mat[0].item(), mats  # the quad is nearer
    assert not hit.hit[2].item()


def test_render_wavefront_chunk_is_a_no_op():
    world, cam = tsc.build_scene(5)
    data, meta = world.compile()
    cam = cam.replace(image_width=16, image_height=16, sqrt_spp=2,
                      bounce_limit=4)
    plain = render_wavefront(data, meta, cam, "cpu", seed=SEED)
    for chunk in (64, 512):
        got = render_wavefront(data, meta, cam, "cpu", seed=SEED,
                               chunk=chunk)
        assert torch.equal(got, plain), chunk
