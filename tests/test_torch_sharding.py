"""Port parity: pixel sharding over torch.distributed ranks, on the CPU.

The counterpart of tests/test_sharding.py and of the elastic resume of
tests/test_subsystems.py.  The port is SPMD, one process a device, so its
ranks are gloo processes: this file starts itself as a worker
(``python tests/test_torch_sharding.py --rank r --world n ...``), once for
each world size — 1, 2, and 4 as the 2-D mesh ``shape=(2, 2)`` — in
module-scoped fixtures.  Each worker runs every sharded entry point on the
three-sphere scene (15x9: the pixel count divides by no mesh size, so the
padding pixels are exercised) and the Cornell box (12x12, 4 spp, depth 8),
counts every ``torch.distributed`` call, and writes its results as
``.npz``.  The workers import torch, numpy and the port only; jax is
imported inside the tests, which hold the port against the JAX package on
its 8-device virtual CPU mesh at the same mesh size (one compile each of
its sharded wavefront, ``render_sharded`` and train step).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import socket
import sys
from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mort_tpu_torch import World, make_camera  # noqa: E402
from mort_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from mort_tpu_torch.parallel.sharding import (  # noqa: E402
    _DIFF_FIELDS, make_mesh, make_train_step, render_sharded,
)
from mort_tpu_torch.render import wavefront  # noqa: E402
from mort_tpu_torch.render.progressive import (  # noqa: E402
    load_state, render_progressive_wavefront,
)
from mort_tpu_torch.render.wavefront import render_wavefront  # noqa: E402
from mort_tpu_torch.scene import scenes as tsc  # noqa: E402

SEED = 11
W3, H3 = 15, 9              # three-sphere size: 135 pixels, no mesh divides
SPT = 2
# the stats' size: 4 spp at spt 1 over pool 1024 is four layer-aligned
# spans, and on 2 ranks different ranks take the most rounds in different
# spans, which 15x9 never shows
W_STATS, H_STATS, POOL_STATS = 80, 45, 1024
WORLDS = {1: None, 2: None, 4: (2, 2)}      # world size -> mesh shape
WORKER_TIMEOUT_S = 300
# every torch.distributed function that talks to another rank
_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "all_to_all", "all_to_all_single",
    "reduce", "gather", "scatter", "send", "recv", "isend", "irecv",
    "barrier")


# ---------------------------------------------------------------------------
# the worker: one rank
# ---------------------------------------------------------------------------

def three_sphere_world():
    """tests/conftest.py's three_sphere_scene, built by the port, at
    W3 x H3."""
    w = World()
    c1 = w.solid_color([0.2, 0.3, 0.1])
    c2 = w.solid_color([0.9, 0.9, 0.9])
    ground = w.lambertian(w.checker(0.32, c1, c2))
    center = w.lambertian(w.solid_color([0.1, 0.2, 0.5]))
    left = w.dielectric(1.5)
    right = w.metal([0.8, 0.6, 0.2], 0.1)
    w.sphere([0, -100.5, -1], 100, ground)
    w.sphere([0, 0, -1], 0.5, center)
    w.sphere([-1, 0, -1], 0.5, left)
    w.sphere([1, 0, -1], 0.5, right)
    data, meta = w.compile()
    cam = make_camera(aspect_ratio=16 / 9, image_width=32,
                      samples_per_pixel=4, bounce_limit=8, vfov=20,
                      lookfrom=[-2, 2, 1], lookat=[0, 0, -1],
                      defocus_angle=10.0, focus_dist=3.4)
    return data, meta, cam.replace(image_width=W3, image_height=H3)


def cornell_world():
    world, cam = tsc.cornell_box()
    data, meta = world.compile()
    return data, meta, cam.replace(image_width=12, image_height=12,
                                   sqrt_spp=2, bounce_limit=8)


class _Interrupted(BaseException):
    pass


def _count_collectives(calls: Counter):
    """Wrap every collective of torch.distributed to count its calls."""
    for name in _COLLECTIVES:
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(dist, name, counted)


def _worker(args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{args.store}", rank=args.rank,
        world_size=args.world, timeout=datetime.timedelta(seconds=120))
    try:
        _worker_body(args)
    finally:
        dist.destroy_process_group()


def _worker_body(args) -> None:
    rank, n = args.rank, args.world
    shape = WORLDS[n]
    out = {}
    calls = Counter()
    _count_collectives(calls)
    mesh = (make_mesh(shape=shape, devices=["cpu"] * n) if shape
            else make_mesh(n, devices=["cpu"] * n))
    out["setup_calls"] = sum(calls.values())
    n_axes = len(mesh.groups)

    # the wavefront; the collectives run while a span runs are counted,
    # and each span's rounds are recorded
    in_spans = Counter()
    rounds = []
    span_core = wavefront._span_core

    def counted_span(*a, **kw):
        before = sum(calls.values())
        res = span_core(*a, **kw)
        in_spans["calls"] += sum(calls.values()) - before
        rounds.append(res[0])
        return res
    wavefront._span_core = counted_span
    data, meta, cam = three_sphere_world()
    before = sum(calls.values())
    img, stats = render_wavefront(data, meta, cam, seed=SEED, spt=SPT,
                                  mesh=mesh, return_stats=True)
    out["wf"] = img.numpy()
    out["wf_calls"] = sum(calls.values()) - before
    out["wf_span_calls"] = in_spans["calls"]
    out["wf_stats_collectives"] = sum(stats["collectives"].values())
    out["wf_span_stat"] = stats["collectives"]["spans"]
    out["per_shard_useful"] = np.asarray(stats["per_shard_useful"])
    out["wf_plain"] = render_wavefront(data, meta, cam, seed=SEED, spt=SPT,
                                       mesh=mesh).numpy()

    # the stats at W_STATS x H_STATS, with this rank's rounds a span
    rounds.clear()
    _, stats = render_wavefront(
        data, meta, cam.replace(image_width=W_STATS, image_height=H_STATS),
        seed=SEED, spt=1, pool=POOL_STATS, mesh=mesh, return_stats=True)
    out["stats_rounds"] = np.asarray(rounds)
    for k in ("iterations", "useful_segments", "slots_executed",
              "per_shard_useful"):
        out[f"stats_{k}"] = np.asarray(stats[k])

    before = sum(calls.values())
    out["sharded"] = render_sharded(data, meta, cam, mesh, seed=SEED)
    out["sharded_calls"] = sum(calls.values()) - before

    # train steps: three-sphere against JAX's target, Cornell against the
    # port's
    inputs = np.load(args.inputs)
    for name, (d, m, c), target in (
            ("ts", (data, meta, cam), inputs["target_ts"]),
            ("cb", cornell_world(), inputs["target_cb"])):
        step = make_train_step(m, mesh)
        before = sum(calls.values())
        loss, grads = step(d, c, target, SEED)
        out[f"{name}_calls"] = sum(calls.values()) - before
        out[f"{name}_all_reduce"] = step.collectives["all_reduce"]
        out[f"{name}_loss"] = loss.numpy()
        for k, g in grads.items():
            out[f"{name}_grad_{k}"] = g.numpy()

    # progressive: uninterrupted; interrupted after two layers with a
    # checkpoint; resumed from the checkpoint of the next larger world
    full = render_progressive_wavefront(data, meta, cam, seed=SEED, spt=1,
                                        mesh=mesh)
    out["prog_full"] = full.fb
    ckpt = os.path.join(args.out, f"ckpt_world{n}.npz")

    def stop_after_two(state):
        if state.samples_done >= 2:
            raise _Interrupted
    try:
        render_progressive_wavefront(data, meta, cam, seed=SEED, spt=1,
                                     mesh=mesh, checkpoint_path=ckpt,
                                     on_step=stop_after_two)
    except _Interrupted:
        pass
    larger = {1: 2, 2: 4}.get(n)
    if larger is not None:
        state = load_state(os.path.join(args.out, f"ckpt_world{larger}.npz"))
        out["resume_from"] = state.samples_done
        out["prog_resumed"] = render_progressive_wavefront(
            data, meta, cam, seed=SEED, spt=1, mesh=mesh, state=state).fb

    # 2 ranks on two (pretended) hosts: an "ici" row may not span them
    if n == 2:
        hostname = socket.gethostname
        socket.gethostname = lambda: f"host{rank}"
        try:
            make_mesh(shape=(1, 2), devices=["cpu"] * n)
            out["row_across_hosts_raised"] = False
        except ValueError:
            out["row_across_hosts_raised"] = True
        out["row_per_host_axes"] = make_mesh(
            shape=(2, 1), devices=["cpu"] * n).axis_names == ("dcn", "ici")
        socket.gethostname = hostname

    out["n_axes"] = n_axes
    np.savez(os.path.join(args.out, f"world{n}_rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _run_world(n, out, inputs):
    """Start the n ranks of one world and wait for them; a rank that fails
    or outlives WORKER_TIMEOUT_S fails the test."""
    store = out / f"store{n}"
    run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--rank", r, "--world",
          n, "--store", store, "--out", out, "--inputs", inputs]
         for r in range(n)],
        [out / f"world{n}_rank{r}.log" for r in range(n)], WORKER_TIMEOUT_S)
    return [dict(np.load(out / f"world{n}_rank{r}.npz", allow_pickle=False))
            for r in range(n)]


@pytest.fixture(scope="module")
def jax_scene(three_sphere_scene):
    """The three-sphere scene in the JAX package at W3 x H3, and its
    lockstep image times 0.9 (the three-sphere train step's target)."""
    from mort_tpu.render.renderer import render as j_render

    jdata, jmeta, jcam = three_sphere_scene
    jcam = jcam.replace(image_width=W3, image_height=H3)
    return jdata, jmeta, jcam, np.asarray(j_render(jdata, jmeta, jcam,
                                                   seed=SEED)) * 0.9


@pytest.fixture(scope="module")
def worlds(jax_scene, tmp_path_factory):
    """Every world's per-rank results: {n: [rank 0's, ...]}.  Worlds run
    from the largest down, each resuming the checkpoint of the one before."""
    from mort_tpu_torch.render.renderer import render

    out = tmp_path_factory.mktemp("sharding")
    data, meta, cam = cornell_world()
    inputs = out / "inputs.npz"
    np.savez(inputs, target_ts=jax_scene[3],
             target_cb=render(data, meta, cam, seed=SEED,
                              device="cpu").numpy() * 0.9)
    return {n: _run_world(n, out, inputs) for n in sorted(WORLDS,
                                                          reverse=True)}


def test_make_mesh_without_a_process_group():
    assert not dist.is_initialized()
    mesh = make_mesh(1, devices=["cpu"])
    assert (mesh.size, mesh.rank, mesh.axis_names, mesh.groups) == (
        1, 0, ("rays",), ())
    assert make_mesh(shape=(1, 1), devices=["cpu"]).axis_names == (
        "dcn", "ici")
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"] * 2)       # needs 2 ranks
    with pytest.raises(ValueError):
        make_mesh(1, shape=(1, 1), devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # the card, unless asked
            make_mesh(1)


def test_one_rank_mesh_equals_the_single_device_paths():
    """``make_mesh(1)`` with no process group: the wavefront is bit-equal
    to the render without a mesh over layer-aligned spans, and the train
    step is ``mesh=None``'s bit for bit."""
    data, meta, cam = three_sphere_world()
    mesh = make_mesh(1, devices=["cpu"])
    img = render_wavefront(data, meta, cam, seed=SEED, spt=SPT, mesh=mesh)
    n_chunks = -(-cam.sqrt_spp ** 2 // SPT)
    assert torch.equal(img, render_wavefront(
        data, meta, cam, "cpu", seed=SEED, spt=SPT,
        layer_range=(0, n_chunks)))
    target = img.numpy() * 0.9
    loss, grads = make_train_step(meta, mesh)(data, cam, target, SEED)
    want_loss, want = make_train_step(meta, device="cpu")(data, cam, target,
                                                          SEED)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(grads[k], want[k]) for k in _DIFF_FIELDS)
    with pytest.raises(ValueError):
        render_wavefront(data, meta, cam, seed=SEED, mesh=mesh,
                         task_range=(0, 8))


def test_every_rank_gets_the_whole_image(worlds):
    for n, ranks in worlds.items():
        for key in ("wf", "sharded", "prog_full", "ts_loss", "cb_loss",
                    "cb_grad_quad_Q"):
            for r in ranks[1:]:
                assert np.array_equal(r[key], ranks[0][key]), (n, key)


def test_wavefront_bit_identical_across_mesh_sizes(worlds, jax_scene):
    """The wavefront over 1, 2 and (2, 2) ranks is bit-identical, and the
    JAX package's mesh-2 wavefront agrees by the image rule."""
    from conftest import assert_images_close
    from mort_tpu.parallel.sharding import make_mesh as j_make_mesh
    from mort_tpu.render.wavefront import render_wavefront as j_render_wf

    imgs = {n: ranks[0]["wf"] for n, ranks in worlds.items()}
    assert imgs[1].shape == (H3, W3, 3) and np.isfinite(imgs[1]).all()
    assert np.array_equal(imgs[2], imgs[1])
    assert np.array_equal(imgs[4], imgs[1])
    for n, ranks in worlds.items():
        assert np.array_equal(ranks[0]["wf_plain"], imgs[1]), n
    jdata, jmeta, jcam, _ = jax_scene
    want = np.asarray(j_render_wf(jdata, jmeta, jcam, seed=SEED, spt=SPT,
                                  mesh=j_make_mesh(2)))
    assert_images_close(imgs[2], want, msg="port mesh2 vs JAX mesh2")


def test_wavefront_sharded_balance(worlds):
    """Round-robin pixels balance the ranks' useful path segments within
    20%, as the JAX package's test holds its 8 shards."""
    useful = worlds[4][0]["per_shard_useful"]
    assert useful.shape == (4,) and useful.min() > 0
    assert useful.max() <= 1.2 * useful.min(), useful


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_wavefront_stats_match_jax(worlds, three_sphere_scene, n):
    """``return_stats`` over a mesh equals the JAX package's at the same
    mesh shape, every stat exactly: ``iterations`` is the sum over spans
    of the largest rank's rounds, at W_STATS x H_STATS, where on 2 ranks
    different ranks take the most rounds in different spans."""
    from mort_tpu.parallel.sharding import make_mesh as j_make_mesh
    from mort_tpu.render.wavefront import render_wavefront as j_render_wf

    ranks = worlds[n]
    rounds = np.stack([r["stats_rounds"] for r in ranks])   # [rank, span]
    assert rounds.shape == (n, 4) and rounds.min() > 0, rounds
    if n == 2:
        leaders = {int(i) for i in rounds.argmax(0)}
        assert leaders == {0, 1}, rounds
        assert rounds.max(0).sum() > rounds.sum(1).max(), rounds
    got = {k: ranks[0][f"stats_{k}"].tolist()
           for k in ("iterations", "useful_segments", "slots_executed",
                     "per_shard_useful")}
    for r in ranks[1:]:
        assert {k: r[f"stats_{k}"].tolist() for k in got} == got
    assert got["iterations"] == rounds.max(0).sum(), (got, rounds)
    jdata, jmeta, jcam = three_sphere_scene
    jmesh = j_make_mesh(shape=WORLDS[n]) if WORLDS[n] else j_make_mesh(n)
    _, want = j_render_wf(
        jdata, jmeta, jcam.replace(image_width=W_STATS, image_height=H_STATS),
        seed=SEED, spt=1, pool=POOL_STATS, mesh=jmesh, return_stats=True)
    assert got == {k: want[k] for k in got}, (got, want)


def test_render_sharded_matches(worlds, jax_scene):
    """``render_sharded`` on 1, 2 and 4 ranks gives the same image (each
    pixel's samples do not depend on its block), and the JAX package's
    mesh-2 ``render_sharded`` agrees by the image rule."""
    from conftest import assert_images_close
    from mort_tpu.parallel.sharding import (
        make_mesh as j_make_mesh, render_sharded as j_render_sharded,
    )

    imgs = {n: ranks[0]["sharded"] for n, ranks in worlds.items()}
    for n in (2, 4):
        assert_images_close(imgs[n], imgs[1], frac_ok=1.0, atol=1e-5,
                            mean_tol=1e-6, msg=f"port mesh{n} vs mesh1")
    jdata, jmeta, jcam, _ = jax_scene
    want = j_render_sharded(jdata, jmeta, jcam, j_make_mesh(2), seed=SEED)
    assert_images_close(imgs[2], want, msg="port mesh2 vs JAX mesh2")


def _grads(res, name):
    return {k: res[f"{name}_grad_{k}"] for k in _DIFF_FIELDS}


def test_train_step_matches_jax(worlds, jax_scene):
    """The three-sphere step over 2 ranks (135 pixels: one padding pixel
    and a padded target) against the JAX package's mesh-2 step: loss rtol
    1e-4, grads rtol 5e-3 and atol 1e-5."""
    import jax
    from mort_tpu.parallel.sharding import (
        make_mesh as j_make_mesh, make_train_step as j_make_train_step,
    )

    jdata, jmeta, jcam, target = jax_scene
    j_loss, j_grads = jax.tree.map(np.asarray, j_make_train_step(
        jmeta, j_make_mesh(2))(jdata, jcam, target, SEED))
    got = worlds[2][0]
    assert np.isfinite(got["ts_loss"])
    np.testing.assert_allclose(got["ts_loss"], j_loss, rtol=1e-4)
    assert np.abs(got["ts_grad_sph_center"]).max() > 0
    for k, g in _grads(got, "ts").items():
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, j_grads[k], rtol=5e-3, atol=1e-5,
                                   err_msg=k)


def test_sharded_train_step_cornell(worlds):
    """The Cornell step (lights, MIS, dielectric, boxes) over 1, 2 and
    (2, 2) ranks: the losses within rtol 1e-4 and the grads within rtol 5e-3
    and atol 1e-5 of the 1-rank step, with signal in the Cornell leaves."""
    one = worlds[1][0]
    g1 = _grads(one, "cb")
    for n in (2, 4):
        res = worlds[n][0]
        np.testing.assert_allclose(res["cb_loss"], one["cb_loss"], rtol=1e-4)
        for k, g in _grads(res, "cb").items():
            assert np.isfinite(g).all(), (n, k)
            np.testing.assert_allclose(g, g1[k], rtol=5e-3, atol=1e-5,
                                       err_msg=f"mesh{n} {k}")
    for k in ("quad_Q", "mat_ior", "tex_color"):
        assert np.abs(worlds[4][0][f"cb_grad_{k}"]).max() > 0, k


def test_collective_counts(worlds):
    """The sharded forward runs no collective inside its spans: only the
    framebuffer's gather (and, with stats, the stats' own), one all-reduce
    a mesh axis each; ``render_sharded`` one a mesh axis; the train step
    exactly its flat gradient bucket's all-reduce, one a mesh axis."""
    for n, ranks in worlds.items():
        for res in ranks:
            axes = int(res["n_axes"])
            assert axes == (2 if WORLDS[n] else 1), n
            assert res["wf_span_calls"] == 0 and res["wf_span_stat"] == 0
            assert res["wf_calls"] == res["wf_stats_collectives"] == 2 * axes
            assert res["sharded_calls"] == axes, n
            for name in ("ts", "cb"):
                assert res[f"{name}_calls"] == res[f"{name}_all_reduce"] \
                    == axes, (n, name)


def test_elastic_resume(worlds):
    """A progressive render checkpointed after two layers on (2, 2) ranks
    resumes on 2, and one checkpointed on 2 resumes on 1, bit-identical to
    the uninterrupted render on any mesh size."""
    full = worlds[1][0]["prog_full"]
    assert np.isfinite(full).all()
    for n in (2, 4):
        assert np.array_equal(worlds[n][0]["prog_full"], full), n
    for n in (1, 2):
        res = worlds[n][0]
        assert res["resume_from"] == 2
        assert np.array_equal(res["prog_resumed"], full), n


def test_ici_rows_stay_on_one_host(worlds):
    res = worlds[2][0]
    assert res["row_across_hosts_raised"]
    assert res["row_per_host_axes"]


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        parser.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--out", "--inputs"):
        parser.add_argument(flag, required=True)
    _worker(parser.parse_args())
