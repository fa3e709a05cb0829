"""A closed loop of train steps: fit the scene to a target image.

The step is ``make_train_step(meta, make_mesh(1))``: the lockstep render
of every pixel, the MSE against the target, and the gradient with respect
to the ten scene leaves.  After each step a plain SGD update (step size
``lr``) builds the next step's ``SceneData``, as a caller of the JAX
package's immutable arrays does.  A step ends when its loss is on the
host, the update is applied and the next ``SceneData`` is built.

Set-up builds the one step object and drives it through the first three
steps (the first captures its graph); the window takes that same object.
The check follows those three steps with the reference: each step's loss,
the first gradient as the update received it ((theta0 - theta1) / lr) and
the change of the leaves after three steps, leaf by leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import bounds, check, window as win
from benchmark.harness.cells import paths_per_unit
from benchmark.harness.profiling import profiled
from benchmark.reference import tracer

LEAVES = tracer.DIFF_LEAVES
SETUP_STEPS = 3


def target_image(ctx) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1): a coarse random image (32-pixel
    cells) drawn from the seed."""
    H, W = ctx.cam["image_height"], ctx.cam["image_width"]
    coarse = win.rng(ctx.seed, "target").random(
        (H // 32 + 1, W // 32 + 1, 3)).astype(np.float32)
    y, x = np.arange(H) // 32, np.arange(W) // 32
    return np.ascontiguousarray(coarse[y[:, None], x[None, :]])


def _host(data) -> dict:
    return {k: getattr(data, k).detach().cpu().numpy().copy() for k in LEAVES}


def setup(ctx):
    import mort_tpu_torch as mt
    from mort_tpu_torch.parallel.sharding import make_mesh, make_train_step

    data, meta = ctx.program_scene()
    data = data.to(ctx.device)
    cam = mt.camera_from_numpy(ctx.cam)
    target = torch.from_numpy(target_image(ctx)).to(ctx.device)
    mesh = (make_mesh(1) if ctx.device.type == "cuda"
            else make_mesh(1, devices=[ctx.device]))
    st = {"step": make_train_step(meta, mesh, use_kernel=True),
          "data": data, "cam": cam,
          "target": target, "meta": meta, "losses": [],
          "seeds": win.unit_seeds(ctx.seed, "steps"),
          "lr": float(ctx.traffic["lr"]), "theta": [_host(data)]}
    t0 = time.perf_counter()
    for k in range(SETUP_STEPS):
        unit(st, k)
        if k == 0:
            st["parts"] = {"first_step": time.perf_counter() - t0}
        if k in (0, SETUP_STEPS - 1):
            st["theta"].append(_host(st["data"]))
    st["parts"]["next_steps"] = time.perf_counter() - t0 - \
        st["parts"]["first_step"]
    return st


def unit(st, k):
    """One train step, its loss on the host, the update applied and the
    next step's SceneData built."""
    data = st["data"]
    loss, grads = st["step"](data, st["cam"], st["target"],
                             seed=st["seeds"][k])
    st["losses"].append(float(loss))
    lr = st["lr"]
    with torch.no_grad():
        st["data"] = data.replace(**{f: getattr(data, f) - lr * grads[f]
                                     for f in LEAVES})


def window(ctx, st):
    w = win.run_units(lambda k: unit(st, SETUP_STEPS + k), ctx.seconds)
    n = w["units"]
    return {"units": n, "wall": w["wall"],
            "setup_losses": st["losses"][:SETUP_STEPS],
            "theta": st["theta"], "seeds": st["seeds"][:SETUP_STEPS],
            "metrics": {"grad_paths_per_s": (n * paths_per_unit(ctx.cam)
                                             / w["wall"], "paths/s")}}


def traced(ctx, st, w):
    """``trace_steps`` steps profiled, each from the scene as set-up
    received it, in a new ``SceneData`` a step as the window's steps have
    it (so each takes the window's copy-in), with the closest hit's
    backward bound from the hit lanes that the reference counts on the
    same paths."""
    from mort_tpu_torch.render import closest_hit as ch

    data0, _ = ctx.program_scene()
    data0 = data0.to(ctx.device)
    seeds = win.unit_seeds(ctx.seed, "trace", int(ctx.traffic["trace_steps"]))
    sub = {"step": st["step"], "cam": st["cam"], "target": st["target"],
           "losses": [], "seeds": seeds, "lr": st["lr"]}
    before = dict(ch.launch_count)

    def steps():
        for k in range(len(seeds)):
            sub["data"] = data0.replace()
            unit(sub, k)

    obs = profiled(steps, ctx.device)
    fwd = sum(ch.launch_count[m] - before[m] for m in ch.ACCELS)
    s = tracer.make_scene(ctx.leaves, ctx.meta, ctx.device)
    cam = tracer.make_cam(ctx.cam, ctx.device)
    rays = cam.W * cam.H
    pix = torch.arange(rays, device=ctx.device)
    bound = 0.0
    for seed in seeds:
        for sample in range(cam.sqrt_spp ** 2):
            hits = []
            with torch.no_grad():
                tracer.trace(s, cam, seed, pix, torch.full_like(pix, sample),
                             hit_counts=hits, full_depth=True)
            bound += sum(bounds.bwd_bound_s(rays, hs, hq, ctx.meta["n_spheres"],
                                            ctx.meta["n_quads"])
                         for hs, hq in hits)
    obs.update(steps=len(seeds), fwd_calls=fwd, bwd_bound_s=bound)
    return obs


def reference_steps(ctx, seeds, dtype=torch.float32, pixel_share=1.0):
    """The reference's own three steps from the inputs: (losses, first
    gradient, change after the steps), gradients and changes as numpy
    leaves.  ``pixel_share`` < 1 keeps that share of the pixels and
    takes the mean over them (a planted fault)."""
    cam = tracer.make_cam(ctx.cam, ctx.device, dtype)
    spp = cam.sqrt_spp ** 2
    n_pix = cam.W * cam.H
    target = torch.from_numpy(target_image(ctx).reshape(-1, 3)).to(
        ctx.device, dtype)
    pix_all = torch.arange(n_pix, device=ctx.device)
    keep = pix_all[:int(n_pix * pixel_share)]
    leaves = dict(ctx.leaves)
    lr = float(ctx.traffic["lr"])
    losses, grads = [], []
    theta0 = {k: np.asarray(ctx.leaves[k], np.float32) for k in LEAVES}
    for seed in seeds:
        s = tracer.make_scene(leaves, ctx.meta, ctx.device, dtype,
                              requires_grad=True)
        with torch.no_grad():
            img = torch.zeros((keep.shape[0], 3), dtype=dtype,
                              device=ctx.device)
            for smp in range(spp):
                img = img + tracer.trace(s, cam, seed, keep,
                                         torch.full_like(keep, smp))
            img = img * (1.0 / spp)
            diff = img - target[keep]
            losses.append(float(torch.mean(diff.float() ** 2)))
            cot = diff * (2.0 / diff.numel()) * (1.0 / spp)
        for smp in range(spp):
            for b0 in range(0, keep.shape[0], 1 << 16):
                p = keep[b0:b0 + (1 << 16)]
                L = tracer.trace(s, cam, seed, p, torch.full_like(p, smp),
                                 differentiable=True)
                torch.autograd.backward(L, cot[b0:b0 + (1 << 16)])
        g = {k: (s.t[k].grad if s.t[k].grad is not None
                 else torch.zeros_like(s.t[k])) for k in LEAVES}
        grads.append({k: v.float().cpu().numpy() for k, v in g.items()})
        with torch.no_grad():
            leaves.update({k: (s.t[k] - lr * g[k]).float().cpu().numpy()
                           for k in LEAVES})
    change = {k: leaves[k].astype(np.float64) - theta0[k] for k in LEAVES}
    return losses, grads[0], change


def program_numbers(w, lr):
    theta0, theta1, theta3 = w["theta"]
    grad = {k: (theta0[k].astype(np.float64) - theta1[k]) / lr
            for k in LEAVES}
    change = {k: theta3[k].astype(np.float64) - theta0[k] for k in LEAVES}
    return w["setup_losses"], grad, change


def fresh_steps(ctx, st):
    """Set-up's three steps again, from the inputs and with the seed of
    ``ctx``, through the same step object: what ``compare`` reads."""
    data, _ = ctx.program_scene()
    sub = {"step": st["step"], "cam": st["cam"],
           "target": torch.from_numpy(target_image(ctx)).to(ctx.device),
           "data": data.to(ctx.device), "losses": [],
           "seeds": win.unit_seeds(ctx.seed, "steps")[:SETUP_STEPS],
           "lr": st["lr"]}
    theta = [_host(sub["data"])]
    for k in range(SETUP_STEPS):
        unit(sub, k)
        if k in (0, SETUP_STEPS - 1):
            theta.append(_host(sub["data"]))
    return {"setup_losses": sub["losses"], "theta": theta,
            "seeds": sub["seeds"]}


def gaps(prog, ref):
    """The three numbers the check compares, from (losses, first
    gradient, change) of the program and of the reference."""
    (lp, gp, cp), (lr_, gr, cr) = prog, ref
    leaves = check.counted_leaves(gr)
    loss = max(abs(a - b) / abs(b) for a, b in zip(lp, lr_))
    return {"loss_gap": float(loss),
            "grad_gap": max(check.norm_gaps(gp, gr, leaves).values()),
            "change_gap": max(check.norm_gaps(cp, cr, leaves).values())}


def compare(ctx, w):
    ref = reference_steps(ctx, w["seeds"])
    numbers = gaps(program_numbers(w, float(ctx.traffic["lr"])), ref)
    ok, _ = check.judge(ctx.limits, numbers)
    return numbers, 0 if ok else SETUP_STEPS
