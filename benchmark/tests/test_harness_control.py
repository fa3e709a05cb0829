"""The control of each cell at a size a test run holds: the reference put
in the program's place and computed in bfloat16, the step below the
configurations' float32, fails the cell's own limits."""

import pytest
import torch

from benchmark.harness import cells, check
from benchmark.harness.window import Context

SMALL = {
    "mort_scene1.frames": dict(image_width=24, samples_per_pixel=4),
    "mort_scene9.frames": dict(image_width=12, samples_per_pixel=4),
    "mort_scene1.fit": dict(image_width=16, image_height=9,
                            samples_per_pixel=4),
    "mort_scene1.preview": dict(image_width=24, samples_per_pixel=4),
}


def context(name, seed=2147483701):
    cell = cells.workload(cells.manifest(), name)
    cfg = cells.config(cell["config"])
    tr = cells.traffic(cell["traffic"])
    cam = cells.camera_fields(cfg, {**tr.get("camera", {}), **SMALL[name]})
    return Context(cell=cell, cfg=cfg, traffic=tr, seed=seed, seconds=0.0,
                   trace=False, device=torch.device("cpu"), cam=cam,
                   limits=cells.limits(name))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_the_limits(name):
    torch.set_num_threads(2)
    ctx = context(name)
    loop = cells.loop(ctx.traffic["loop"])
    if ctx.traffic["loop"] == "fit":
        seeds = [11, 12, 13]
        ref = loop.reference_steps(ctx, seeds)
        low = loop.reference_steps(ctx, seeds, torch.bfloat16)
        numbers = loop.gaps(low, ref)
    else:
        pix = loop.setup_pixels(ctx)
        if ctx.traffic["loop"] == "frames":
            ref = loop.reference_pixels(ctx, 21, pix)
            low = loop.reference_pixels(ctx, 21, pix, torch.bfloat16)
        else:
            cmds = [("frame",)] * 3 + [("mouse", 20, -10)] + [("frame",)] * 3
            ref = loop.reference_frame(ctx, cmds, pix, 21)
            low = loop.reference_frame(ctx, cmds, pix, 21, torch.bfloat16)
        numbers = {"px_off": float(check.pixels_off(low, ref).mean())}
    ok, lines = check.judge(ctx.limits, numbers)
    assert not ok, lines
