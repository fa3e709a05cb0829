"""Where the benchmark's parts live, found by the names in BENCHMARK.json.

Every configuration, traffic mix, cell limit and per-layer metric is a
file of its own, so a later change adds a cell by adding files:

* ``configs/<config>.json``: the scene (its builder, the builder's
  parameters and the camera), its source, ``reduced`` and ``assumed``;
* ``scenes/<builder>.py``: ``build(scene_params, World) -> World``, the
  scene's description on the program's ``World`` or the reference's;
* ``traffic/<traffic>.json``: the loop that drives the program
  (``loops/<loop>.py``) and its parameters;
* ``limits/<workload>.json``: each number the check compares, with its
  limit and the readings it was set from;
* ``metrics/<metric>.py``: ``read(obs)``, one per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(workload_name: str) -> dict:
    return _json("limits", workload_name)


def loop(name: str):
    """The module of a traffic's loop (``loops/<name>.py``)."""
    return importlib.import_module(f"benchmark.loops.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded from its path (metric names hold
    dots, so it is not imported as a package member)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cfg: dict, world_cls):
    """The configuration's scene described on a new ``world_cls``."""
    mod = importlib.import_module(f"benchmark.scenes.{cfg['builder']}")
    return mod.build(cfg["scene"], world_cls)


def scene(cfg: dict):
    """(leaves, meta): the reference's plain flattening of the
    configuration's scene (``harness/world.py``)."""
    from benchmark.harness.world import World
    return build(cfg, World).compile()


def program_scene(cfg: dict):
    """(SceneData, SceneMeta) on the host: the same description compiled
    by the program, in the program's own layout."""
    import mort_tpu_torch as mt
    return build(cfg, mt.World).compile()


def camera_fields(cfg: dict, overrides: dict | None = None) -> dict:
    """The fields of the program's ``Camera`` (``camera_from_numpy``) from
    a configuration's camera, with a traffic's overrides (image width and
    height, samples per pixel, depth); the height defaults to the width
    over the aspect ratio."""
    c = dict(cfg["camera"])
    c.update(overrides or {})
    W = int(c["image_width"])
    return {
        "lookfrom": c["lookfrom"], "lookat": c["lookat"], "vup": c["vup"],
        "vfov": c["vfov"], "defocus_angle": c["defocus_angle"],
        "focus_dist": c["focus_dist"], "background": c["background"],
        "image_width": W,
        "image_height": int(c.get("image_height")
                            or max(1, int(W / float(c["aspect_ratio"])))),
        "sqrt_spp": max(1, int(math.sqrt(int(c["samples_per_pixel"])))),
        "bounce_limit": int(c["bounce_limit"]),
    }


def paths_per_unit(cam: dict) -> int:
    """Camera paths of one pass over the image: pixels x effective spp."""
    return cam["image_width"] * cam["image_height"] * cam["sqrt_spp"] ** 2
