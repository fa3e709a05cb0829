"""BENCHMARK.json against the contract, and each part found by name."""

import json
import re
import shutil

import numpy as np
import pytest

from benchmark.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return cells.manifest()


def test_keys_and_names(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in man["configs"]]
    names += [w["name"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in man[kind]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(ms) == len(set(ms))


def test_limits_of_the_contract(man):
    assert 1 <= man["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in man["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(man).encode()) <= 64 * 1024


def test_every_part_is_found_by_name(man):
    for c in man["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = cells.config(c["name"])
        leaves, meta = cells.scene(cfg)
        assert meta["n_spheres"] + meta["n_quads"] > 0
        assert cfg["reduced"] == c["reduced"]
    for w in man["workloads"]:
        cells.config(w["config"])
        tr = cells.traffic(w["traffic"])
        assert hasattr(cells.loop(tr["loop"]), "window")
        assert cells.limits(w["name"])["numbers"]
    for m in man["per_layer"]:
        assert callable(cells.metric_reader(m["name"]).read)


SPHERE = ("sph_center", "sph_cvec", "sph_radius", "sph_mat", "sph_surface")
QUAD = ("quad_Q", "quad_u", "quad_v", "quad_mat", "quad_surface")
TABLES = ("mat_tex", "mat_albedo", "mat_fuzz", "mat_ior", "tex_color",
          "tex_inv_scale", "tex_child_even", "tex_child_odd",
          "tex_noise_scale", "tex_image_id", "med_neg_inv_density")


def _rows(get, names, n):
    """[n, k] float64: the first ``n`` rows of the named leaves side by
    side."""
    cols = [np.asarray(get(k), np.float64)[:n] for k in names]
    return np.concatenate([c if c.ndim > 1 else c[:, None] for c in cols],
                          axis=1)


def _sorted(rows):
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("config", ["mort_scene1", "mort_scene9"])
def test_program_and_reference_compile_the_same_scene(config):
    """The program packs the description in its own layout (row order,
    padding, acceleration tables), the reference flattens it plainly:
    the same primitives, materials, textures, media and lights."""
    cfg = cells.config(config)
    leaves, meta = cells.scene(cfg)
    data, pmeta = cells.program_scene(cfg)

    def prog(k):
        return getattr(data, k).numpy()

    def ref(k):
        return leaves[k]

    ns, nq = meta["n_spheres"], meta["n_quads"]
    assert (pmeta.n_spheres, pmeta.n_quads) == (ns, nq)
    assert ns + nq > 0
    for names, n in ((SPHERE, ns), (QUAD, nq)):
        np.testing.assert_array_equal(_sorted(_rows(prog, names, n)),
                                      _sorted(_rows(ref, names, n)))
    for k in TABLES:
        np.testing.assert_array_equal(prog(k), ref(k), err_msg=k)
    for a, b in zip(data.images, leaves["images"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert len(data.images) == meta["n_images"]
    for k in ("mat_kind", "tex_kind", "any_moving"):
        assert tuple(np.atleast_1d(getattr(pmeta, k))) == \
            tuple(np.atleast_1d(meta[k])), k
    assert pmeta.n_noise == meta["n_noise"]

    def rows_of(get, sph, quad):
        return (_sorted(_rows(lambda k: get(k)[list(sph)], SPHERE, len(sph))),
                _sorted(_rows(lambda k: get(k)[list(quad)], QUAD, len(quad))))

    assert len(pmeta.media) == len(meta["media"])
    for pm, rm in zip(pmeta.media, meta["media"]):
        assert pm.mat_row == rm["mat_row"]
        for a, b in zip(rows_of(prog, pm.sphere_rows, pm.quad_rows),
                        rows_of(ref, rm["sphere_rows"], rm["quad_rows"])):
            np.testing.assert_array_equal(a, b)
    pl = [(l.kind, l.row) for l in pmeta.lights]
    rl = [(l["kind"], l["row"]) for l in meta["lights"]]
    assert sorted(k for k, _ in pl) == sorted(k for k, _ in rl)
    for a, b in zip(rows_of(prog, [r for k, r in pl if k == 1],
                            [r for k, r in pl if k == 2]),
                    rows_of(ref, [r for k, r in rl if k == 1],
                            [r for k, r in rl if k == 2])):
        np.testing.assert_array_equal(a, b)


def test_every_config_has_a_cell(man):
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}


def test_every_metric_reported_where_it_is_moved(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells_of = {m: set(v.get("workloads", [w["name"] for w in
                                           man["workloads"]]))
                for m, v in e2e.items()}
    for w in man["workloads"]:
        mine = {m for m, c in cells_of.items() if w["name"] in c}
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in
                   man["per_layer"])
    for m in man["per_layer"]:
        for w in m["workloads"]:
            assert w in cells_of[m["moves"]], (m["name"], w)


def test_a_cell_is_added_by_files_alone(tmp_path, monkeypatch, man):
    """A new configuration, traffic mix, metric and cell: new files and
    entries only, found by name without editing any file there."""
    root = tmp_path / "repo"
    shutil.copytree(cells.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs/mort_scene1.json").read_text())
    cfg.update(name="dummy_scene")
    cfg["scene"]["grid_half_span"] = 2
    (bench / "configs/dummy_scene.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic/frames.json").read_text())
    tr["check_frames"] = 1
    (bench / "traffic/dummy_mix.json").write_text(json.dumps(tr))
    (bench / "metrics/dummy.metric.py").write_text(
        "def read(obs):\n    return 1.0\n")
    (bench / "limits/dummy_scene.dummy_mix.json").write_text(
        json.dumps({"numbers": {"px_off": {"limit": 0.1}}}))
    m = dict(man)
    m["configs"] = man["configs"] + [dict(man["configs"][0],
                                          name="dummy_scene")]
    m["workloads"] = man["workloads"] + [dict(
        name="dummy_scene.dummy_mix", config="dummy_scene",
        traffic="dummy_mix", chips=1, why="a dummy")]
    m["per_layer"] = man["per_layer"] + [dict(
        man["per_layer"][0], name="dummy.metric",
        workloads=["dummy_scene.dummy_mix"])]
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    monkeypatch.setattr(cells, "BENCH", bench)
    got = cells.workload(cells.manifest(root), "dummy_scene.dummy_mix")
    leaves, meta = cells.scene(cells.config(got["config"]))
    assert meta["n_spheres"] < 485
    assert cells.traffic(got["traffic"])["check_frames"] == 1
    assert cells.limits(got["name"])["numbers"]["px_off"]["limit"] == 0.1
    assert cells.metric_reader("dummy.metric").read({}) == 1.0
