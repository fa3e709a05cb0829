"""Port parity: the gradient of the closest hit (the autograd Function
``closest_hit._ClosestHit``, whose backward is the CUDA kernel
``closest_hit_bwd`` on a card and ``closest_hit_bwd_reference`` here).

The same leaves, rays and cotangents go through the JAX package's custom
VJP of its Pallas kernel (interpret mode) and through the port, each
composed with its own ``quad_frames``, ``build_prim_table`` and packing, so
the gradients compare at the scene leaves and the rays.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mort_tpu import World
from mort_tpu.render import pallas_intersect as pal
from mort_tpu.render.intersect import quad_frames as j_quad_frames
from mort_tpu.render.primtable import build_prim_table as j_prim_table
from mort_tpu_torch.parallel.sharding import _DIFF_FIELDS
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.intersect import K_QUAD, K_SPHERE, quad_frames
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.render.vec import V3
from mort_tpu_torch.scene.build import scene_from_numpy

N_RAYS = 1 << 10


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _mixed_world(n_sph=8, n_quad=5, moving=True):
    """The moving scene of test_pallas_kernel.py::_mixed_world."""
    rng = np.random.RandomState(1)
    w = World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(n_sph):
        c = rng.randn(3) * 3
        if moving and i % 2 == 0:
            w.sphere(c, 0.3 + rng.rand(), m, center2=c + rng.randn(3) * 0.5)
        else:
            w.sphere(c, 0.3 + rng.rand(), m)
    for _ in range(n_quad):
        w.quad(rng.randn(3) * 3, rng.randn(3) * 2, rng.randn(3) * 2, m)
    return w


def _inputs(n=N_RAYS, seed=3):
    rs = np.random.RandomState(seed)
    ro = (rs.randn(n, 3) * 6).astype(np.float32)
    rd = rs.randn(n, 3).astype(np.float32)
    tme = rs.rand(n).astype(np.float32)
    dt = rs.randn(n).astype(np.float32)
    drow = rs.randn(ch.ROW_K, n).astype(np.float32)
    return ro, rd, tme, dt, drow


@pytest.fixture(scope="module")
def scene():
    jdata, jmeta = _mixed_world().compile()
    return jdata, jmeta, scene_from_numpy(_fields(jdata), _fields(jmeta))


def _port_grads(data, meta, ro, rd, tme, dt, drow, accel="none"):
    """d(t . dt + row . drow) w.r.t. the ten leaves and ro, rd, through
    quad_frames, build_prim_table, pack_scene and the Function."""
    leaves = {k: getattr(data, k).clone().requires_grad_()
              for k in _DIFF_FIELDS}
    d = data.replace(**leaves)
    qf = quad_frames(d)
    table, _ = build_prim_table(d, meta, qf)
    packed = ch.pack_scene(d, meta, qf, table, accel)
    ro_t = torch.from_numpy(ro).requires_grad_()
    rd_t = torch.from_numpy(rd).requires_grad_()
    t, _kind, _idx, row = ch.closest_hit(packed, V3.from_rows(ro_t),
                                         V3.from_rows(rd_t),
                                         torch.from_numpy(tme))
    grads = torch.autograd.grad(
        [t, row], list(leaves.values()) + [ro_t, rd_t],
        grad_outputs=[torch.from_numpy(dt), torch.from_numpy(drow)],
        allow_unused=True, materialize_grads=True)
    out = dict(zip(list(leaves) + ["ro", "rd"], (g.numpy() for g in grads)))
    return out, packed


def test_vjp_matches_jax_kernel(scene):
    jdata, jmeta, (data, meta) = scene
    ro, rd, tme, dt, drow = _inputs()

    def j_fn(leaves, ro_, rd_):
        d = jdata.replace(**leaves)
        qf = j_quad_frames(d)
        table, _ = j_prim_table(d, jmeta, qf)
        t, _k, _i, row = pal.closest_hit_pallas(
            d, jmeta, qf, table, ro_, rd_, jnp.asarray(tme), interpret=True,
            accel="none")
        return t, row

    leaves0 = {k: getattr(jdata, k) for k in _DIFF_FIELDS}
    _, vjp = jax.vjp(j_fn, leaves0, jnp.asarray(ro), jnp.asarray(rd))
    j_leaves, j_ro, j_rd = vjp((jnp.asarray(dt), jnp.asarray(drow)))
    want = {k: np.asarray(v) for k, v in j_leaves.items()}
    want.update(ro=np.asarray(j_ro), rd=np.asarray(j_rd))

    got, _ = _port_grads(data, meta, ro, rd, tme, dt, drow)
    hits = 0
    for k, w in want.items():
        g = got[k]
        assert np.isfinite(g).all(), k
        # rtol 1e-4 as asked; atol 2e-5 max|g| because JAX recomputes
        # half_b and c_term through its packed ray basis, in another
        # float32 summation order, and a winner's partials carry
        # 1/sqrt(disc), which amplifies that rounding on near-grazing
        # lanes: measured largest |diff| / max|g| = 9.4e-6 (on ro), 6e-6
        # on the sphere leaves
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=k)
        hits += np.abs(w).max() > 0
    assert hits >= 9     # every leaf but mat_albedo (lambertian) is live


def test_accel_modes_give_the_same_gradients(scene):
    """The backward does not depend on the mode (the forward gives the
    same winner in every mode), and the cull boxes and the tree are built
    detached even when the leaves require grad."""
    _jdata, _jmeta, (data, meta) = scene
    inputs = _inputs(256, seed=5)
    base, packed = _port_grads(data, meta, *inputs, accel="none")
    assert packed.accel_tab is None
    for accel in ("cull", "bvh"):
        got, packed = _port_grads(data, meta, *inputs, accel=accel)
        assert packed.accel_tab is not None
        assert packed.accel_tab.grad_fn is None
        assert not packed.accel_tab.requires_grad
        assert packed.sph.grad_fn is not None
        for k in base:
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)


def test_misses_put_no_gradient_on_joined_row_0(scene):
    """A miss reads joined row 0 in the forward; its cotangent is dropped,
    so row 0 (a real sphere's shading row) and the rays get nothing."""
    _jdata, _jmeta, (data, meta) = scene
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    joined = table.clone().requires_grad_()
    packed = ch.pack_scene(data, meta, qf, joined)
    n = 64
    ro = torch.full((n, 3), 100.0).requires_grad_()    # far outside, away
    rd = torch.tensor([[1.0, 0.5, 0.25]]).repeat(n, 1)
    t, kind, _idx, row = ch.closest_hit(packed, V3.from_rows(ro),
                                        V3.from_rows(rd), torch.rand(n))
    assert (kind == 0).all() and torch.isinf(t).all()
    assert torch.equal(row[:ch.ROW_T], table[0][:, None].expand(-1, n))
    rs = np.random.RandomState(2)
    g_j, g_ro = torch.autograd.grad(
        [t, row], [joined, ro],
        grad_outputs=[torch.from_numpy(rs.randn(n).astype(np.float32)),
                      torch.from_numpy(rs.randn(32, n).astype(np.float32))])
    assert torch.count_nonzero(g_j) == 0
    assert torch.count_nonzero(g_ro) == 0


def _quadratic_f64(sph, rays, idx):
    """half_b, c_term and a of each lane's sphere record idx, float64."""
    o, d, tm = rays[0:3], rays[3:6], rays[6]
    rec = sph[idx.long().clamp(max=sph.shape[0] - 1)].T
    c, cv = rec[0:3], rec[3:6]
    half_b = (o * d).sum(0) - (c * d).sum(0) - tm * (cv * d).sum(0)
    c_term = ((o * o).sum(0) - 2 * (c * o).sum(0) - 2 * tm * (cv * o).sum(0)
              + rec[6] + tm * rec[7] + tm * tm * rec[8])
    return half_b, c_term, (d * d).sum(0)


def _t_winner_f64(sph, quad, rays, kind, idx, far):
    """The winner's t in float64 from its record and the ray (the forward
    frozen at its winner and root choice)."""
    o, d = rays[0:3], rays[3:6]
    half_b, c_term, a = _quadratic_f64(sph, rays, idx)
    s = kind == K_SPHERE
    disc = torch.where(s, half_b * half_b - a * c_term, 1.0)
    sgn = torch.where(far, 1.0, -1.0).double()
    t = torch.where(s, (-half_b + sgn * torch.sqrt(disc)) / a, 0.0)
    q = kind == K_QUAD
    qrec = quad[idx.long().clamp(max=quad.shape[0] - 1)].T
    n = qrec[0:3]
    den = torch.where(q, (n * d).sum(0), 1.0)
    return t + torch.where(q, (qrec[3] - (n * o).sum(0)) / den, 0.0)


def test_plain_backward_equals_float64_autograd(scene):
    """``closest_hit_bwd_reference`` against torch autograd of a float64
    recomputation of the winner's t (and of the row gather), on lanes clear
    of silhouettes (a sphere lane contributes only where the ray passes
    within 0.95 r of the centre), where 1/sqrt(disc) stays tame."""
    _jdata, _jmeta, (data, meta) = scene
    ro, rd, tme, dt, drow = _inputs()
    # aim the rays at the primitives' centres (random rays hit few spheres)
    rs = np.random.RandomState(4)
    quad_mid = data.quad_Q + 0.5 * (data.quad_u + data.quad_v)
    aims = torch.cat([data.sph_center, quad_mid]).numpy()
    aim = aims[rs.randint(0, len(aims), len(ro))] + rs.randn(len(ro), 3) * 0.3
    rd = (aim - ro).astype(np.float32)
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    packed = ch.pack_scene(data, meta, qf, table)
    rays = ch.stack_rays(V3.from_rows(torch.from_numpy(ro)),
                         V3.from_rows(torch.from_numpy(rd)),
                         torch.from_numpy(tme))
    row = ch.closest_hit_reference(packed, rays)
    kind = row[ch.ROW_KIND].to(torch.int32)
    idx = row[ch.ROW_IDX].to(torch.int32)

    sph64 = packed.sph.double().requires_grad_()
    quad64 = packed.quad.double().requires_grad_()
    rays64 = rays.double().requires_grad_()
    joined64 = packed.joined.double().requires_grad_()
    with torch.no_grad():
        half_b, c_term, a = _quadratic_f64(sph64, rays64, idx)
        disc = half_b * half_b - a * c_term
        # the forward's root choice: the far root sits past the midpoint
        # -half_b / a of the two roots
        far = row[ch.ROW_T].double() * a > -half_b
        # disc = a (r^2 - b^2) with b the ray's distance from the centre:
        # a lane is clear where b^2 <= 0.9 r^2
        r = data.sph_radius[idx.long().clamp(
            max=data.sph_radius.shape[0] - 1)].double()
        clear = (kind == K_QUAD) | (
            (kind == K_SPHERE) & (disc >= 0.1 * a * r * r))
    t64 = _t_winner_f64(sph64, quad64, rays64, kind, idx, far)
    assert int(((kind == K_SPHERE) & clear).sum()) > 200
    assert int(((kind == K_QUAD) & clear).sum()) > 100
    dt_c = torch.where(clear, torch.from_numpy(dt), 0.0)
    drow_c = torch.where(clear, torch.from_numpy(drow), 0.0)
    hit = kind != 0
    g = torch.where(kind == K_QUAD, idx + packed.quad_base, idx).long()
    rows = joined64[g].T                    # the row gather, float64
    loss = ((torch.where(hit, t64, 0.0) * (dt_c + drow_c[ch.ROW_T]).double())
            .sum() + (torch.where(hit, rows, 0.0)
                      * drow_c[:ch.ROW_T].double()).sum())
    want = torch.autograd.grad(loss, [rays64, sph64, quad64, joined64])

    got = ch.closest_hit_bwd_reference(rays, kind, idx, dt_c, drow_c,
                                       packed.sph, packed.quad,
                                       tuple(packed.joined.shape),
                                       packed.quad_base)
    for name, g32, w in zip(("rays", "sph", "quad", "joined"), got, want):
        w = w.numpy()
        # float32 against float64 on well-conditioned lanes
        np.testing.assert_allclose(g32.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert ch.launch_count["bwd"] == 0          # the CPU launches nothing
