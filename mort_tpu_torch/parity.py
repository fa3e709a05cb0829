"""Image parity gate: the production render path on the card against the
JAX package's CPU reference images.

The port's counterpart of ``tools/tpu_parity.py``, with its 13 configs and
its rules.  Per-sample bit parity across two implementations of a chaotic
integral cannot hold (a 1e-6 change of a direction decorrelates a path
within a few bounces), so the statement is statistical:

* noise floor: mean|card(seed A) - ref(seed A)| must not exceed
  ``NOISE_FACTOR`` x mean|card(seed A) - card(seed B)| + ``NOISE_ABS``: the
  reference is as close to the card's image as an independent sample of
  the card's own image;
* bias: each channel mean of the card's image must agree with the
  reference's within ``MEAN_RTOL`` relative (``MEAN_ATOL`` floor);
* every image is finite.

A real defect (wrong geometry, shading or RNG) fails both; a
reduced-precision dot, the fault that darkened the JAX package's TPU
images by ~28% (DEVIATIONS.md section 6), fails the bias rule.

The card has no jax, so the reference images were rendered once by the
JAX package's CPU lockstep ``render`` at seed ``SEED_A`` (exactly as
``tools/tpu_parity.py::render_cpu_refs``) and are committed as
``data/parity_refs.npz``; ``python tests/test_torch_parity.py --regen``
remakes them where jax is installed.  Scenes 3, 8 and 9 use the
procedural earth texture on both sides when ``assets/earthmap.jpg`` is
absent (``scene.scenes.load_earthmap``); the record says which.

    python -m mort_tpu_torch.parity [--out chiprun_out/parity.json]
    python -m mort_tpu_torch.parity --device cpu --only 2

Writes its record to ``--out`` and exits non-zero when a config fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .device import device_line, require_cuda
from .render.closest_hit import auto_accel
from .render.wavefront import render_wavefront
from .scene import scenes as sc

WIDTH = 120
SPP = 16
DEPTH = 10
SEED_A = 69420
SEED_B = 1337

# all ten reference scenes at the standard config, scene 6 at the depth of
# the reference's deep-bounce scenes, and scene 1 through the "bvh" and
# "cull" kernels, which the auto policy gives no reference scene
CONFIGS = (
    [{"scene": i, "depth": DEPTH, "accel": None} for i in range(1, 11)]
    + [{"scene": 6, "depth": 50, "accel": None},
       {"scene": 1, "depth": DEPTH, "accel": "bvh"},
       {"scene": 1, "depth": DEPTH, "accel": "cull"}]
)

NOISE_FACTOR = 1.3    # reference distance <= 1.3x the same-spp MC noise
NOISE_ABS = 0.01      # ... plus this absolute slack
MEAN_RTOL = 0.02      # per-channel image-mean agreement
MEAN_ATOL = 0.005

REFS = Path(__file__).resolve().parent / "data" / "parity_refs.npz"
DEFAULT_OUT = os.path.join("chiprun_out", "parity.json")


def cfg_label(cfg) -> str:
    lab = str(cfg["scene"])
    if cfg["depth"] != DEPTH:
        lab += f"@d{cfg['depth']}"
    if cfg["accel"]:
        lab += f"@{cfg['accel']}"
    return lab


def ref_key(cfg) -> str:
    """The reference image of a config: scene and depth only (the accel is
    a kernel mode of the card's path; the lockstep reference has none)."""
    return f"{cfg['scene']}@d{cfg['depth']}"


def cam_for(cam, depth=DEPTH):
    h = max(1, int(WIDTH * cam.image_height / cam.image_width))
    return cam.replace(image_width=WIDTH, image_height=h,
                       sqrt_spp=int(np.sqrt(SPP)), bounce_limit=depth)


def load_refs(path=REFS):
    """(images {ref_key: [H, W, 3] float32}, meta dict) of a references
    file."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["meta"]))
        images = {k: f[k] for k in f.files if k != "meta"}
    return images, meta


def earthmap_source() -> str:
    """Which earth texture scenes 3, 8 and 9 get in this process."""
    for path in sc._EARTHMAP_CANDIDATES:
        if path and os.path.exists(path):
            return os.path.abspath(path)
    return "procedural"


def gate(img_a, img_b, want) -> dict:
    """The parity rules on the card's images at seeds A and B against the
    reference image ``want`` (all [H, W, 3])."""
    img_a, img_b, want = (np.asarray(x, np.float32)
                          for x in (img_a, img_b, want))
    cross = float(np.abs(img_a - want).mean())
    noise = float(np.abs(img_a - img_b).mean())
    mean_a = img_a.mean(axis=(0, 1))
    mean_ref = want.mean(axis=(0, 1))
    mean_err = float(np.max(np.abs(mean_a - mean_ref)
                            / np.maximum(np.abs(mean_ref), MEAN_ATOL)))
    ok_noise = cross <= NOISE_FACTOR * noise + NOISE_ABS
    ok_mean = mean_err <= MEAN_RTOL
    finite = bool(np.isfinite(img_a).all() and np.isfinite(img_b).all())
    return {"cross": cross, "noise": noise, "mean_err": mean_err,
            "ok_noise": bool(ok_noise), "ok_mean": bool(ok_mean),
            "ok": bool(ok_noise and ok_mean and finite)}


def run_config(cfg, want, device):
    """Render one config at seeds A and B on ``device`` and gate it:
    (its record, with ``TPU_PARITY.json``'s keys, and the seconds of the
    two renders)."""
    world, cam = sc.build_scene(cfg["scene"])
    data, meta = world.compile()
    cam = cam_for(cam, cfg["depth"])
    n_prims = meta.n_spheres + meta.n_quads
    accel = cfg["accel"] or auto_accel(n_prims)
    t0 = time.perf_counter()
    img_a, img_b = (render_wavefront(data, meta, cam, device, seed=seed,
                                     accel=accel).cpu().numpy()
                    for seed in (SEED_A, SEED_B))
    seconds = time.perf_counter() - t0
    g = gate(img_a, img_b, want)
    return {
        "scene": cfg["scene"], "label": cfg_label(cfg),
        "width": cam.image_width, "height": cam.image_height, "spp": SPP,
        "depth": cfg["depth"], "accel": accel,
        "forced_accel": bool(cfg["accel"]), "n_prims": int(n_prims),
        "cross_backend_mean_abs": round(g["cross"], 5),
        "mc_noise_mean_abs": round(g["noise"], 5),
        "cross_over_noise": round(g["cross"] / max(g["noise"], 1e-9), 3),
        "channel_mean_rel_err": round(g["mean_err"], 5),
        "ok_noise": g["ok_noise"], "ok_mean": g["ok_mean"], "ok": g["ok"],
    }, seconds


def run(device=None, configs=None, refs=None, log=None) -> dict:
    """Every config of ``configs`` (None: ``CONFIGS``) on ``device``
    (None: the card) against the references in ``refs`` (None:
    ``REFS``); returns the record (``ok`` False when a config fails)."""
    device = require_cuda() if device is None else torch.device(device)
    configs = CONFIGS if configs is None else configs
    refs = REFS if refs is None else refs
    images, meta = load_refs(refs)
    results, seconds = [], {}
    for cfg in configs:
        rec, s = run_config(cfg, images[ref_key(cfg)], device)
        results.append(rec)
        seconds[rec["label"]] = s
        if log is not None:
            log(f"  scene {rec['label']} ({rec['accel']}, {rec['n_prims']} "
                f"prims): cross={rec['cross_backend_mean_abs']:.4f} "
                f"noise={rec['mc_noise_mean_abs']:.4f} "
                f"ratio={rec['cross_over_noise']:.3f} "
                f"mean_rel={rec['channel_mean_rel_err']:.4f} "
                f"{s:.2f} s -> {'OK' if rec['ok'] else 'FAIL'}")
    return {
        "backend": device_line(device),
        "config": {"width": WIDTH, "spp": SPP, "base_depth": DEPTH,
                   "n_configs": len(configs), "seeds": [SEED_A, SEED_B],
                   "noise_factor": NOISE_FACTOR, "noise_abs": NOISE_ABS,
                   "mean_rtol": MEAN_RTOL},
        "comparison": "mort_tpu_torch render_wavefront (CUDA closest-hit "
                      "kernel, default or forced accel) on this device vs "
                      "the JAX package's CPU lockstep render (committed "
                      "references); mean abs diff gated by the same-spp MC "
                      "noise floor (seed A vs seed B on this device) + "
                      "per-channel image-mean bias check",
        "references": {"file": Path(refs).name, "seed": meta["seed"], "source_digest": meta["digest"],
                       "earthmap": meta["earthmap"]},
        "earthmap": earthmap_source(),
        "scenes": results,
        "seconds": seconds,
        "ok": all(r["ok"] for r in results),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mort_tpu_torch.parity",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"record path (default {DEFAULT_OUT})")
    ap.add_argument("--only", nargs="*", default=None,
                    help="config labels to run (default: all 13)")
    args = ap.parse_args(argv)
    configs = CONFIGS if args.only is None else [
        c for c in CONFIGS if cfg_label(c) in args.only]
    if not configs:
        ap.error(f"no config among {[cfg_label(c) for c in CONFIGS]}")
    rec = run(args.device, configs,
              log=lambda m: print(m, file=sys.stderr, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {os.path.abspath(args.out)} ok={rec['ok']}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
