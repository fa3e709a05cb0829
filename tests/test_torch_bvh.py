"""The "cull" and "bvh" closest-hit modes' boxes and schedules, on the CPU.

``closest_hit.bvh_tree`` is an implicit heap whose leaves are single rows
(sphere rows first, then quad rows, in the scene builder's Morton order);
node k stores the boxes of its two children.  ``closest_hit.cull_boxes``
is the JAX package's ``cluster_boxes`` of CL-row sub-clusters.  Both are
widened (``closest_hit._widen``): each box by AAB_SLACK times its largest
|coordinate| plus the ``sphere_pad`` of that coordinate and its spheres'
smallest radius, and each ray's slab by the same terms of its max |o|.

The CUDA "bvh" kernel visits a node by slab-testing both children's boxes,
goes on into the entered child with the smaller slab entry and marks the
other, if it was entered too, in a 32-bit trail (one bit a level); at a
leaf or a dead end it resumes at the sibling of the deepest marked level.
The "cull" kernels slab-test every sub-cluster box for each ray (the
bound +inf), bin the pairs (ray, entered sub-cluster) sub-cluster-major in
ray order by a counting sort, test each bin's rays against its sub-
cluster's rows, and fold each pair's (t, row) minimum into the ray's sphere
or quad key by an integer minimum.  ``_bvh_mirror`` and ``_cull_mirror``
below are those schedules in plain torch: each must equal
``closest_hit_reference`` (every primitive tested) bit for bit on every ray
set, and does not without the widening; ``_cull_bins`` is held against a
brute-force listing of the pairs.  The kernels themselves are held against
the plain version on the card (test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import box_bounds, box_edge_rays, silhouette_rays

from mort_tpu_torch.camera import derive_basis, get_rays_soa
from mort_tpu_torch.render import closest_hit as ch
from mort_tpu_torch.render.intersect import INF, T_MIN, first_min, quad_frames
from mort_tpu_torch.render.primtable import build_prim_table
from mort_tpu_torch.scene import scenes as sc

_dot3 = ch._dot3
# The "cull" kernels' schedule constants, mirrored from the .cu
CULL_TILE = 256    # rays of a mask/place tile: kThreads
CULL_CHUNK = 128   # listed rays of a test chunk: kCullThreads


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: the mirrors run thousands of ops on
    tensors of a few thousand elements, where OpenMP's fork and join cost
    more than the work (the module takes 12 s on one thread, 32 s on eight
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(world, accel="bvh"):
    """(data, meta, packed) of a port World."""
    data, meta = world.compile()
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    return data, meta, ch.pack_scene(data, meta, qf, table, accel)


def _spread_world(n):
    """test_torch_accel.py's spread-spheres scene, built by the port."""
    rng = np.random.RandomState(9)
    w = sc.World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(n):
        c = [i * 5.0 - n * 2.5, rng.randn() * 2, rng.randn() * 2]
        w.sphere(c, 0.4 + rng.rand(), m)
    return w


def _near_miss_rays(data, meta, n, g, dist=3000.0):
    """n rays from ``dist`` away that pass a random surface sphere (at its
    centre at time 0.5) at 1.05 to 4 radii, in random directions: the
    float32 test reports hits on some of them, outside the sphere's box."""
    surf = np.nonzero(data.sph_surface[:meta.n_spheres].numpy())[0]
    k = surf[g.randint(0, surf.size, n)]
    c = (data.sph_center[k].double().numpy()
         + data.sph_cvec[k].double().numpy() * 0.5)
    r = np.abs(data.sph_radius[k].double().numpy())
    d = g.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = g.randn(n, 3)
    e -= (e * d).sum(1, keepdims=True) * d
    e *= (r * g.uniform(1.05, 4.0, n) / np.linalg.norm(e, axis=1))[:, None]
    rays = torch.zeros(8, n)
    rays[0:3] = torch.from_numpy((c + e - dist * d).astype(np.float32)).T
    rays[3:6] = torch.from_numpy(d.astype(np.float32)).T
    rays[6] = 0.5
    return rays


def _camera_bounce(packed, cam, n, g):
    """n camera rays of ``cam`` and a random bounce from each hit point
    (origins on surfaces)."""
    pix = torch.from_numpy(g.randint(0, cam.image_width * cam.image_height,
                                     n).astype(np.int64))
    smp = torch.from_numpy(g.randint(0, cam.sqrt_spp ** 2, n).astype(
        np.int64))
    ro, rd, tme = get_rays_soa(cam, derive_basis(cam), 69420, pix, smp,
                               no_defocus=True)
    rays = ch.stack_rays(ro, rd, tme)
    t = ch.closest_hit_reference(packed, rays)[ch.ROW_T]
    hit = torch.isfinite(t)
    bounce = torch.zeros(8, int(hit.sum()))
    bounce[0:3] = (rays[0:3] + rays[3:6] * t)[:, hit]
    bounce[3:6] = torch.from_numpy(g.randn(3, bounce.shape[1]).astype(
        np.float32))
    bounce[6] = rays[6, hit]
    return torch.cat([rays, bounce], dim=1)


def _row_values(packed, rays, chunk=256):
    """closest_hit_reference's per-(ray, row) values, in its own chunked
    layout (so torch's CPU square root rounds each exactly as there): the
    a-scaled sphere roots [R, n_sph] and the quad t [R, n_quad], +inf where
    the row is no hit."""
    ox, oy, oz, dx, dy, dz, tm = (rays[k][:, None] for k in range(7))
    a = _dot3(dx, dy, dz, dx, dy, dz)
    ro_rd = _dot3(ox, oy, oz, dx, dy, dz)
    ro_sq = _dot3(ox, oy, oz, ox, oy, oz)
    tdx, tdy, tdz = tm * dx, tm * dy, tm * dz
    tox, toy, toz = tm * ox, tm * oy, tm * oz
    tt = tm * tm
    tmin_a = a * T_MIN
    roots = []
    for s in range(0, packed.n_sph, chunk):
        cx, cy, cz, vx, vy, vz, ctc_r2, ccv2, vv, surf = \
            packed.sph[s:min(s + chunk, packed.n_sph)].unbind(1)
        half_b = ((ro_rd - _dot3(dx, dy, dz, cx, cy, cz))
                  - _dot3(tdx, tdy, tdz, vx, vy, vz))
        c_term = (((((ro_sq - 2.0 * _dot3(ox, oy, oz, cx, cy, cz))
                     - 2.0 * _dot3(tox, toy, toz, vx, vy, vz))
                    + ctc_r2) + tm * ccv2) + tt * vv)
        disc = half_b * half_b - a * c_term
        ok = disc >= 0.0
        sq = torch.sqrt(torch.where(ok, disc, 0.0))
        root1 = -half_b - sq
        root = torch.where(root1 > tmin_a, root1, root1 + 2.0 * sq)
        valid = ok & (root > tmin_a) & (surf != 0.0)
        roots.append(torch.where(valid, root, INF))
    ts = []
    for s in range(0, packed.n_quad, chunk):
        (nx, ny, nz, D, ax_, ay_, az_, qa, bx_, by_, bz_, qb,
         surf) = packed.quad[s:min(s + chunk, packed.n_quad)].unbind(1)
        den = _dot3(nx, ny, nz, dx, dy, dz)
        ok = torch.abs(den) >= 1e-8
        num = D - _dot3(nx, ny, nz, ox, oy, oz)
        t = torch.where(ok, num / torch.where(ok, den, 1.0), -1.0)
        alpha = ((_dot3(ax_, ay_, az_, ox, oy, oz) - qa)
                 + t * _dot3(ax_, ay_, az_, dx, dy, dz))
        beta = ((_dot3(bx_, by_, bz_, ox, oy, oz) - qb)
                + t * _dot3(bx_, by_, bz_, dx, dy, dz))
        valid = (ok & (t > T_MIN) & (alpha >= 0.0) & (alpha <= 1.0)
                 & (beta >= 0.0) & (beta <= 1.0) & (surf != 0.0))
        ts.append(torch.where(valid, t, INF))
    R = rays.shape[1]
    return (torch.cat(roots, 1) if roots else torch.empty(R, 0),
            torch.cat(ts, 1) if ts else torch.empty(R, 0))


def _lex_update(t, i, v, row):
    better = (v < t) | ((v == t) & (row < i))
    return torch.where(better, v, t), torch.where(better, row, i)


def _slab_terms(rays, r_min):
    """The kernels' per-ray slab terms (make_slab): the reciprocal direction
    (|d| < 1e-30 becomes +-1e-30) and the t offsets of the planes widened by
    the ray's part of the pad, [R, 3] each."""
    o, d = rays[0:3].T, rays[3:6].T
    tiny = torch.where(d >= 0.0, 1e-30, -1e-30)
    ir = 1.0 / torch.where(d.abs() < 1e-30, tiny, d)
    s = o.abs().amax(dim=1, keepdim=True)
    m = s * ch.AAB_SLACK + ch.sphere_pad(s, r_min)
    return ir, (o + m) * ir, (o - m) * ir


def _enters(lo, hi, ir, o_lo, o_hi, bound):
    """box_enters over the last (axis) dimension: (entered, slab entry).
    The plane offsets round twice here where the kernel's fused
    multiply-add rounds once; the widening covers both."""
    t_lo, t_hi = lo * ir - o_lo, hi * ir - o_hi
    near = torch.minimum(t_lo, t_hi).amax(dim=-1)
    far = torch.maximum(t_lo, t_hi).amin(dim=-1)
    return ((lo[..., 0] <= hi[..., 0]) & (near <= far) & (far > T_MIN)
            & (near <= bound)), near


def _merge(best, best_i, qt, qi, rcp_a):
    """emit's merge: (t, kind, idx), a sphere winning an exact tie."""
    st = best * rcp_a
    q_better = qt < st
    t = torch.where(q_better, qt, st)
    kind = torch.where(t < INF, torch.where(q_better, 2, 1), 0)
    return t, kind, torch.where(q_better, qi, best_i)


def _bvh_mirror(packed, rays, sph_v, quad_v):
    """The "bvh" kernel's schedule over the per-(ray, row) values of
    ``_row_values``: returns (t, kind, idx, counts), counts = (sphere tests,
    quad tests, node slab tests)."""
    R = rays.shape[1]
    nodes, L, n_sph = packed.accel_tab, packed.n_accel, packed.n_sph
    d = rays[3:6].T
    rcp_a = 1.0 / _dot3(*d.T, *d.T)
    ir, o_lo, o_hi = _slab_terms(rays, nodes[0, 0])

    best = torch.full((R,), INF)
    qt = torch.full((R,), INF)
    best_i = torch.zeros(R, dtype=torch.long)
    qi = torch.zeros(R, dtype=torch.long)
    node = torch.ones(R, dtype=torch.long)
    depth = torch.zeros(R, dtype=torch.long)
    trail = torch.zeros(R, dtype=torch.long)
    live = torch.ones(R, dtype=torch.bool)
    n_s = n_q = n_b = 0
    while live.any():
        lanes = live.nonzero().squeeze(1)
        inner = node[lanes] < L
        # internal nodes: both children's slab tests
        k = lanes[inner]
        rec = nodes[node[k]].reshape(-1, 3, 2, 2).transpose(1, 2)
        bound = torch.minimum(best[k] * rcp_a[k], qt[k])
        enter, near = _enters(rec[..., 0], rec[..., 1], ir[k, None],
                              o_lo[k, None], o_hi[k, None], bound[:, None])
        n_b += 2 * k.numel()
        both = enter.all(dim=1)
        trail[k] |= torch.where(both, torch.bitwise_left_shift(1, depth[k]), 0)
        go = enter.any(dim=1)
        child = torch.where(both, (near[:, 1] < near[:, 0]).long(),
                            enter[:, 1].long())
        g = k[go]
        node[g] = 2 * node[g] + child[go]
        depth[g] += 1
        # leaves: one row each, sphere rows first
        f = lanes[~inner]
        j = node[f] - L
        sl = j < n_sph
        fs, rs = f[sl], j[sl]
        n_s += int((packed.sph[rs, 9] != 0).sum())
        best[fs], best_i[fs] = _lex_update(best[fs], best_i[fs],
                                           sph_v[fs, rs], rs)
        fq, rq = f[~sl], j[~sl] - n_sph
        n_q += int((packed.quad[rq, 12] != 0).sum())
        qt[fq], qi[fq] = _lex_update(qt[fq], qi[fq], quad_v[fq, rq], rq)
        # leaves and dead ends resume at the deepest marked level's sibling
        p = torch.cat([k[~go], f])
        done = trail[p] == 0
        live[p[done]] = False
        p = p[~done]
        lvl = torch.floor(torch.log2(trail[p].double())).long()
        trail[p] ^= torch.bitwise_left_shift(1, lvl)
        node[p] = (node[p] >> (depth[p] - lvl - 1)) ^ 1
        depth[p] = lvl + 1
    return (*_merge(best, best_i, qt, qi, rcp_a), (n_s, n_q, n_b))


def _cull_mask(packed, rays):
    """The "cull" mask kernel's entries [R, n_sub] bool: box_enters against
    every box of ``cull_boxes`` with the bound +inf."""
    box = packed.accel_tab
    ir, o_lo, o_hi = _slab_terms(rays, box[0, 6])
    enter, _ = _enters(box[None, :, 0:3], box[None, :, 3:6], ir[:, None],
                       o_lo[:, None], o_hi[:, None], INF)
    return enter


def _cull_bins(enter):
    """The bins of the "cull" scan, bins and place kernels from the mask
    [R, n_sub]: each tile of CULL_TILE rays counts each sub-cluster's rays,
    the tiles' counts are scanned per sub-cluster, the bins' lengths over
    the sub-clusters, and a ray's slot is its bin's first slot plus its
    tile's plus its rank among the tile's rays that enter (the warps'
    counts before it plus its lane's ballot prefix: the tile's exclusive
    prefix in ray order).  Returns (bin_off [n_sub + 1], bins [pairs] ray
    indices, chunk_off [n_sub + 1] in chunks of CULL_CHUNK slots)."""
    R, n_sub = enter.shape
    T = CULL_TILE
    n_tiles = -(-R // T)
    e = torch.zeros(n_tiles * T, n_sub, dtype=torch.long)
    e[:R] = enter.long()
    e = e.reshape(n_tiles, T, n_sub)
    count = e.sum(dim=1)
    tile_first = torch.cumsum(count, 0) - count
    total = count.sum(dim=0)
    bin_off = torch.cat([total.new_zeros(1), torch.cumsum(total, 0)])
    rank = torch.cumsum(e, dim=1) - e
    slot = bin_off[:-1] + tile_first[:, None] + rank
    bins = torch.full((int(bin_off[-1]),), -1, dtype=torch.long)
    ray = torch.arange(n_tiles * T).reshape(n_tiles, T, 1).expand_as(e)
    on = e.bool()
    bins[slot[on]] = ray[on]
    chunks = -(-total // CULL_CHUNK)
    chunk_off = torch.cat([chunks.new_zeros(1), torch.cumsum(chunks, 0)])
    return bin_off, bins, chunk_off


def _key(t, row):
    """The kernel's key of a candidate: (t bits << 32) | row, int64."""
    bits = t.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return bits << 32 | row


def _cull_mirror(packed, rays, sph_v, quad_v):
    """The "cull" kernels' schedule over the per-(ray, row) values of
    ``_row_values``: the mask (bound +inf), the bins, each listed ray's
    lexicographic (t, row) minimum over its bin's sub-cluster rows, folded
    into its sphere or quad key by the minimum of the keys, and emit's
    merge.  Returns (t, kind, idx, counts), counts = (sphere tests, quad
    tests, box slab tests)."""
    R = rays.shape[1]
    n_ss, n_sub = packed.n_sph_sub, packed.n_accel
    d = rays[3:6].T
    rcp_a = 1.0 / _dot3(*d.T, *d.T)
    bin_off, bins, _ = _cull_bins(_cull_mask(packed, rays))
    miss = _key(torch.tensor([INF]), 0)
    keys = {True: miss.expand(R).clone(), False: miss.expand(R).clone()}
    n_s = n_q = 0
    for s in range(n_sub):
        lanes = bins[bin_off[s]:bin_off[s + 1]]
        sphere = s < n_ss
        q = s if sphere else s - n_ss
        tab, vals = (packed.sph, sph_v) if sphere else (packed.quad, quad_v)
        rows = slice(q * ch.CL, min((q + 1) * ch.CL, vals.shape[1]))
        if rows.start >= rows.stop or lanes.numel() == 0:
            continue
        v, j = first_min(vals[lanes, rows])
        n_test = lanes.numel() * int((tab[rows, -1] != 0).sum())
        if sphere:
            n_s += n_test
        else:
            n_q += n_test
        hit = v < INF
        keys[sphere].scatter_reduce_(0, lanes[hit],
                                     _key(v[hit], j[hit] + rows.start),
                                     "amin")
    (best, best_i), (qt, qi) = (
        ((keys[k] >> 32).int().view(torch.float32), keys[k] & 0xFFFFFFFF)
        for k in (True, False))
    return (*_merge(best, best_i, qt, qi, rcp_a), (n_s, n_q, R * n_sub))


MIRRORS = {"bvh": _bvh_mirror, "cull": _cull_mirror}


def _leaf_rows_boxes(data, meta):
    """Per-row boxes of every surface row, in leaf order (spheres, then
    quads): (lo [n, 3], hi [n, 3], leaf of each row, radius of each row,
    +inf for a quad)."""
    ns, nq = meta.n_spheres, meta.n_quads
    c, cv = data.sph_center[:ns], data.sph_cvec[:ns]
    r = data.sph_radius[:ns].abs()
    q_lo, q_hi = ch.quad_bounds(data)
    lo = torch.cat([torch.minimum(c, c + cv) - r[:, None], q_lo[:nq]])
    hi = torch.cat([torch.maximum(c, c + cv) + r[:, None], q_hi[:nq]])
    leaf = torch.arange(ns + nq)
    radius = torch.cat([r, torch.full((nq,), float("inf"))])
    surf = torch.cat([data.sph_surface[:ns], data.quad_surface[:nq]])
    return lo[surf], hi[surf], leaf[surf], radius[surf]


def _sub_world(n_sph, n_quad):
    """Spheres (a third of them moving) and quads, with a non-surface row
    among them: a medium's boundary sphere."""
    rs = np.random.RandomState(7)
    w = sc.World()
    m = w.lambertian(w.solid_color([0.5, 0.5, 0.5]))
    for i in range(n_sph):
        c = rs.randn(3) * 4
        w.sphere(c, 0.2 + rs.rand(), m, center2=c + rs.randn(3) * 0.3
                 if i % 3 == 0 else None)
    for _ in range(n_quad):
        w.quad(rs.randn(3) * 4, rs.randn(3), rs.randn(3), m)
    w.constant_medium(w.sphere([0, 0, 0], 2.0, m, skip=True), 0.1,
                      w.isotropic(w.solid_color([0.2, 0.4, 0.9])))
    return w


SMALL_WORLDS = {
    "mixed_with_skip_rows": lambda: _sub_world(37, 11),
    "one_sphere": lambda: _sub_world(1, 0),
    "quads_only": lambda: _sub_world(0, 5),
}


def _heap_boxes(nodes, L):
    """(lo, hi) [2L, 3] of heap nodes 0 .. 2L-1 (nodes 0 and 1 inverted):
    node k's row of the table holds children 2k and 2k+1."""
    rec = nodes[1:].reshape(L - 1, 3, 2, 2)
    lo = torch.cat([torch.full((2, 3), ch.BIG),
                    rec[..., 0].transpose(1, 2).reshape(-1, 3)])
    hi = torch.cat([torch.full((2, 3), -ch.BIG),
                    rec[..., 1].transpose(1, 2).reshape(-1, 3)])
    return lo, hi


def _padded(lo, hi, r):
    """The pad of boxes (lo, hi) [n, 3] with spheres' smallest radius r
    [n, 1]: AAB_SLACK times the largest |coordinate| plus its sphere_pad."""
    scale = torch.maximum(lo.abs(), hi.abs()).amax(dim=1, keepdim=True)
    return scale * ch.AAB_SLACK + ch.sphere_pad(scale, r)


@pytest.mark.parametrize("name", ["spread600", "scene9", "scene1"]
                         + list(SMALL_WORLDS))
def test_tree_boxes_contain_their_rows(scenes, name):
    if name in SMALL_WORLDS:
        data, meta, packed = _pack(SMALL_WORLDS[name]())
    else:
        data, meta, packed, _ = scenes[name]
    nodes, L = packed.accel_tab, packed.n_accel
    n_leaf = meta.n_spheres + meta.n_quads
    assert nodes.shape == (L, ch.NODE_COLS) and L >= 2 and L & (L - 1) == 0
    assert n_leaf <= L and (L == 2 or 2 * n_leaf > L)
    lo, hi = _heap_boxes(nodes, L)
    # a leaf box is its row's box widened by its pad
    r_lo, r_hi, leaf, radius = _leaf_rows_boxes(data, meta)
    assert leaf.numel() > 0
    idx = leaf[:, None].expand(-1, 3)
    u_lo = torch.full((L, 3), ch.BIG).scatter(0, idx, r_lo)
    u_hi = torch.full((L, 3), -ch.BIG).scatter(0, idx, r_hi)
    r_leaf = torch.full((L,), ch.BIG).scatter(
        0, leaf, radius.clamp(max=ch.BIG))[:, None]
    m = _padded(u_lo, u_hi, r_leaf)
    real = (u_lo[:, 0] <= u_hi[:, 0])[:, None]
    assert torch.equal(lo[L:], torch.where(real, u_lo - m, u_lo))
    assert torch.equal(hi[L:], torch.where(real, u_hi + m, u_hi))
    assert bool((lo[L + leaf] <= r_lo).all() and (hi[L + leaf] >= r_hi).all())
    # each node's two boxes contain their subtrees' leaf boxes
    real = lo[:, 0] <= hi[:, 0]
    v = torch.arange(2, 2 * L)
    v = v[real[v]]
    for _ in range(L.bit_length()):
        parent = v // 2
        inner = parent >= 2
        v, parent = v[inner], parent[inner]
        assert bool((lo[parent] <= lo[v]).all()
                    and (hi[parent] >= hi[v]).all())
        v = parent
    # skip rows and padding are inverted; row 0 holds the smallest radius
    # of a surface sphere (BIG without one) for the per-ray widening
    assert real[L + leaf].all() and int(real[L:].sum()) == leaf.numel()
    r_min = radius.min().clamp(max=ch.BIG)
    assert float(nodes[0, 0]) == float(r_min) and not bool(nodes[0, 1:].any())


@pytest.mark.parametrize("name", ["scene9", "scene1"] + list(SMALL_WORLDS))
def test_cull_boxes_are_cluster_boxes_widened(scenes, name):
    if name in SMALL_WORLDS:
        data, meta, packed = _pack(SMALL_WORLDS[name](), "cull")
    else:
        data, meta = scenes[name][:2]
        packed = _pack_like(scenes[name], "cull")
    box, cb = packed.accel_tab, ch.cluster_boxes(data, meta)
    assert box.shape == cb.shape == (packed.n_accel, ch.BOX_COLS)
    # each sub-cluster's pad: from its largest |coordinate| and the smallest
    # radius of its surface spheres (BIG for a quad sub-cluster)
    n_ss = packed.n_sph_sub
    r = torch.full((box.shape[0], 1), ch.BIG)
    ns = data.sph_center.shape[0]
    rad = torch.where(data.sph_surface, data.sph_radius.abs(), ch.BIG)
    for s in range(n_ss):
        if s * ch.CL < ns:
            r[s] = rad[s * ch.CL:(s + 1) * ch.CL].min()
    m = _padded(cb[:, 0:3], cb[:, 3:6], r)
    real = (cb[:, 0] <= cb[:, 3])[:, None]
    assert real.any()
    assert torch.equal(box[:, 0:3], torch.where(real, cb[:, 0:3] - m,
                                                cb[:, 0:3]))
    assert torch.equal(box[:, 3:6], torch.where(real, cb[:, 3:6] + m,
                                                cb[:, 3:6]))
    assert torch.equal(box[:, 6], torch.full_like(box[:, 6], float(r.min())))
    assert not bool(box[:, 7].any())


def _pack_like(scene, accel):
    """The packed table of another mode for a ``scenes`` entry."""
    data, meta = scene[:2]
    qf = quad_frames(data)
    table, _ = build_prim_table(data, meta, qf)
    return ch.pack_scene(data, meta, qf, table, accel)


@pytest.fixture(scope="module")
def scenes():
    """name -> (data, meta, packed "bvh" on the CPU, camera), built once."""
    worlds = {"spread600": (_spread_world(600), None),
              "one_sphere": (SMALL_WORLDS["one_sphere"](), None),
              "scene1": sc.random_spheres(),
              "scene9": sc.final_scene(400, 250, 4),
              "spread16k": sc.spread_spheres()}
    return {k: (*_pack(w), cam) for k, (w, cam) in worlds.items()}


def _rays(scenes, case, n):
    """(scene name, [8, n] rays) of a ray set."""
    name, kind = case.split("/")
    data, meta, packed, cam = scenes[name]
    g = np.random.RandomState((CASES + CULL_CASES).index(case))
    if kind == "random":
        ro, rd = g.randn(2, n, 3).astype(np.float32) * [[[30.0]], [[1.0]]]
        rays = torch.zeros(8, n)
        rays[0:3], rays[3:6] = torch.from_numpy(ro.T), torch.from_numpy(rd.T)
        rays[6] = torch.from_numpy(g.rand(n).astype(np.float32))
        return name, rays
    if kind == "camera_bounce":
        # camera rays, then rays from their hit points (origins on surfaces)
        return name, _camera_bounce(packed, cam, n // 2, g)
    if kind == "silhouettes":
        return name, silhouette_rays(data, meta, cam.lookfrom, n,
                                     CASES.index(case))
    if kind == "near_misses":
        return name, _near_miss_rays(data, meta, n, g)
    origins, tiny = {"edges": (("camera", "far", "face", "inside"), 0.15),
                     "edges_from_far": (("far",), 0.0),
                     "tiny_components": (("camera", "far", "face",
                                          "inside"), 1.0)}[kind]
    return name, box_edge_rays(*box_bounds(data, meta), cam.lookfrom, n,
                               CASES.index(case), origins, tiny)


CASES = ("spread600/random", "scene9/camera_bounce", "scene1/camera_bounce",
         "scene1/silhouettes", "spread16k/silhouettes", "scene9/silhouettes",
         "scene9/edges", "scene9/edges_from_far", "scene9/tiny_components")
# the "cull" mirror's cases: the ray sets that reach its sub-clusters'
# boundaries (its boxes hold 128 rows each, so camera rays enter most), and
# near misses of a lone small sphere from far away, which its box alone
# holds
CULL_CASES = ("scene1/silhouettes", "spread16k/silhouettes",
              "scene9/silhouettes", "scene9/edges_from_far",
              "scene9/tiny_components", "one_sphere/near_misses")


_PLAIN = {}


def _plain(scenes, case, n):
    """(rays, the plain version's output, the per-(ray, row) values) of a
    ray set, computed once for every mode and test that uses it."""
    if (case, n) not in _PLAIN:
        name, rays = _rays(scenes, case, n)
        packed = scenes[name][2]
        _PLAIN[case, n] = (rays, ch.closest_hit_reference(packed, rays),
                           _row_values(packed, rays))
    return _PLAIN[case, n]


def _mirror_vs_plain(scenes, mode, case, n):
    name = case.split("/")[0]
    packed = scenes[name][2]
    if mode != "bvh":
        packed = _pack_like(scenes[name], mode)
    rays, want, values = _plain(scenes, case, n)
    t, kind, idx, counts = MIRRORS[mode](packed, rays, *values)
    same = ((t == want[ch.ROW_T]) & (kind == want[ch.ROW_KIND])
            & (idx == want[ch.ROW_IDX]))
    return packed, want, same, counts


@pytest.mark.parametrize("mode,case", [("bvh", c) for c in CASES]
                         + [("cull", c) for c in CULL_CASES])
def test_schedule_equals_plain(scenes, mode, case):
    n = 256 if case.startswith("spread16k") else 1024
    packed, want, same, (n_s, n_q, n_b) = _mirror_vs_plain(scenes, mode,
                                                           case, n)
    assert bool((want[ch.ROW_KIND] > 0).any())
    assert bool(same.all()), f"{int((~same).sum())} rays differ"
    # and the boxes prune: a ray tests fewer rows than the scene holds
    share = 0.05 if mode == "bvh" else 0.7
    assert n_s + n_q < share * n * (packed.n_sph + packed.n_quad)
    assert n_b > 0 or mode == "cull"


@pytest.mark.parametrize("mode,case", [("bvh", "scene1/silhouettes"),
                                       ("bvh", "spread16k/silhouettes"),
                                       ("bvh", "scene9/silhouettes"),
                                       ("cull", "one_sphere/near_misses")])
def test_schedule_needs_the_slack(scenes, mode, case, monkeypatch):
    """Without the widening (AAB_SLACK and SPHERE_ERR 0, in the boxes and
    per ray) the schedule prunes winners the plain version reports: the
    expanded sphere quadratic's hits near silhouettes, outside the
    sphere's box.  "cull" slab-tests with no running bound, so it loses
    such a hit only where the ray misses the whole sub-cluster box: a lone
    small sphere's, passed at 1.05-4 radii from 3000 units."""
    monkeypatch.setattr(ch, "AAB_SLACK", 0.0)
    monkeypatch.setattr(ch, "SPHERE_ERR", 0.0)
    name = case.split("/")[0]
    data, meta, _, cam = scenes[name]
    bare = dict(scenes, **{name: (data, meta, _pack_like(scenes[name],
                                                         "bvh"), cam)})
    n = 256 if name == "spread16k" else 1024
    _, _, same, _ = _mirror_vs_plain(bare, mode, case, n)
    assert not bool(same.all())


@pytest.mark.parametrize("case", CULL_CASES + ("scene9/camera_bounce",))
def test_cull_bins_list_every_pair_once(scenes, case):
    """The "cull" bins hold every entered (ray, sub-cluster) pair exactly
    once, sub-cluster by sub-cluster and in ray order within a bin, as a
    brute-force listing of the mask does, at a ray count off the tile; and
    the test kernel's chunks (the last sub-cluster whose first chunk is at
    most g, then CULL_CHUNK slots from its first) cover the slots once."""
    name = case.split("/")[0]
    packed = _pack_like(scenes[name], "cull")
    _, rays = _rays(scenes, case, 1024)
    rays = rays[:, :rays.shape[1] - 3]
    enter = _cull_mask(packed, rays)
    bin_off, bins, chunk_off = _cull_bins(enter)
    e = enter.numpy()
    want = np.concatenate([np.nonzero(e[:, s])[0]
                           for s in range(e.shape[1])])
    assert want.size > 0 and bins.numpy().tolist() == want.tolist()
    assert bin_off.numpy().tolist() == [0] + np.cumsum(e.sum(0)).tolist()
    covered = np.zeros(want.size, dtype=np.int64)
    offs = chunk_off.numpy()
    for g in range(int(offs[-1])):
        s = int(np.searchsorted(offs, g, side="right")) - 1
        first = int(bin_off[s]) + (g - int(offs[s])) * CULL_CHUNK
        n = min(CULL_CHUNK, int(bin_off[s + 1]) - first)
        assert n > 0
        covered[first:first + n] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("R, n_sub", [(1, 1), (1000, 28), (1 << 18, 128),
                                      (1 << 18, 782), (37, 1 << 26)])
def test_cull_slices_cover_the_rays(R, n_sub):
    """The "cull" wrapper's launches cover the rays once, in order, each
    within CULL_MAX_PAIRS bin slots (one ray a launch where one ray's
    sub-clusters exceed it): spread16k at its main path's R is one launch,
    100k primitives at the same R no longer exceed the bins' int32 slots."""
    slices = ch.cull_slices(R, n_sub)
    assert slices[0][0] == 0 and slices[-1][1] == R
    assert all(a < b for a, b in slices)
    assert all(b == a2 for (_, b), (a2, _) in zip(slices, slices[1:]))
    assert all((b - a) * n_sub <= max(ch.CULL_MAX_PAIRS, n_sub)
               for a, b in slices)
    assert all((b - a) * n_sub < 2 ** 31 for a, b in slices)
    if R * n_sub <= ch.CULL_MAX_PAIRS:
        assert slices == [(0, R)]


@pytest.mark.parametrize("name", ["scene1", "spread16k", "scene9"])
def test_sphere_error_model(scenes, name):
    """The bound the widening rests on: a sphere hit the float32 test
    reports on grazing rays lies within sqrt(r^2 + K 2^-24 S^2) of the
    sphere's centre at the ray's time, S = max |o| + max |c| + max |cv| + r,
    with K at most half of SPHERE_ERR's 64."""
    data, meta, packed, cam = scenes[name]
    n = 1024 if name == "spread16k" else 2048
    rays = silhouette_rays(data, meta, cam.lookfrom, n, 21)
    roots, _ = _row_values(packed, rays)
    ray, row = torch.isfinite(roots).nonzero(as_tuple=True)
    assert ray.numel() > n // 2
    o, d, tm = (rays[0:3, ray].T.double(), rays[3:6, ray].T.double(),
                rays[6, ray].double()[:, None])
    t = roots[ray, row].double() / (d * d).sum(dim=1)
    c, cv = data.sph_center[row].double(), data.sph_cvec[row].double()
    r = data.sph_radius[row].double().abs()
    err = ((o + t[:, None] * d - c - tm * cv) ** 2).sum(dim=1) - r * r
    S = o.abs().amax(dim=1) + (c.abs() + cv.abs()).amax(dim=1) + r
    K = float((err / (2.0 ** -24 * S * S)).max())
    assert 1.0 < K <= ch.SPHERE_ERR * 2.0 ** 24 / 2
