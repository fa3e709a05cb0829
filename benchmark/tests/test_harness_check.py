"""The check decides ``correct``: sound runs pass it, and a run whose
timed path is broken underneath fails it.  Each drives ``run.main`` on
the CPU at a small size (the card's look skipped); the limits are the
cells' own."""

import json

import numpy as np
import pytest
import torch

from benchmark import run

SMALL = {
    "mort_scene1.frames": dict(image_width=24, samples_per_pixel=4),
    "mort_scene9.frames": dict(image_width=12, samples_per_pixel=4),
    "mort_scene1.fit": dict(image_width=16, image_height=9,
                            samples_per_pixel=4),
    "mort_scene1.preview": dict(image_width=24, samples_per_pixel=4),
}


def drive(cell, capsys, seconds="0.5"):
    torch.set_num_threads(2)
    rc = run.main(["--workload", cell, "--seed", "2147483693",
                   "--seconds", seconds, "--trace", "0"], device="cpu",
                  camera=SMALL[cell])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell, capsys):
    res = drive(cell, capsys)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"


# --- the frames cells -------------------------------------------------------

def _wrap_render(monkeypatch, fn):
    from mort_tpu_torch.render import wavefront
    real = wavefront.render_wavefront

    def broken(*a, **kw):
        return fn(real, *a, **kw)

    monkeypatch.setattr(wavefront, "render_wavefront", broken)


def test_frames_state_unchanged_fails(monkeypatch, capsys):
    """Each frame returns its framebuffer as it started: no deposit."""
    def stale(real, *a, **kw):
        out = real(*a, **kw)
        if "task_range" in kw:          # the warm-up span
            return out
        img, stats = out
        return torch.zeros_like(img), stats
    _wrap_render(monkeypatch, stale)
    res = drive("mort_scene1.frames", capsys)
    assert not res["correct"], res["checks"]


def test_frames_half_the_samples_fails(monkeypatch, capsys):
    """Half of each pixel's samples left out, the mean over the rest."""
    def half(real, data, meta, cam, device, **kw):
        if "task_range" in kw:
            return real(data, meta, cam, device, **kw)
        n = cam.sqrt_spp ** 2
        img, stats = real(data, meta, cam, device, spt=1,
                          layer_range=(0, n // 2), **kw)
        return img * 2.0, stats
    _wrap_render(monkeypatch, half)
    res = drive("mort_scene1.frames", capsys)
    assert not res["correct"], res["checks"]


def test_frames_altered_answer_fails(monkeypatch, capsys):
    """The image altered where it is produced: red 5% brighter."""
    def altered(real, *a, **kw):
        out = real(*a, **kw)
        if "task_range" in kw:
            return out
        img, stats = out
        img = img.clone()
        img[..., 0] *= 1.05
        return img, stats
    _wrap_render(monkeypatch, altered)
    res = drive("mort_scene9.frames", capsys)
    assert not res["correct"], res["checks"]


# --- the viewer -------------------------------------------------------------

def _no_camera_events(monkeypatch):
    """Frames only, so the returned frame holds every layer of the window
    (a fault in the accumulation shows from the second frame on)."""
    from benchmark.harness import cells
    real = cells.traffic

    def traffic(name):
        tr = dict(real(name))
        if tr["loop"] == "preview":
            tr["frames_per_move"] = 10 ** 6
        return tr
    monkeypatch.setattr(cells, "traffic", traffic)


def test_preview_layers_not_accumulated_fails(monkeypatch, capsys):
    """A state returned unchanged: each frame's layer drops the ones
    before it (the accumulator is not carried)."""
    from mort_tpu_torch import interactive
    real = interactive.render_wavefront

    def forget(*a, fb=None, **kw):
        return real(*a, fb=None, **kw)
    monkeypatch.setattr(interactive, "render_wavefront", forget)
    _no_camera_events(monkeypatch)
    res = drive("mort_scene1.preview", capsys, seconds="2")
    assert res["attempted"] >= 2 and not res["correct"], res["checks"]


def test_preview_half_the_layers_fails(monkeypatch, capsys):
    """Every other layer left out, the mean taken over the rest."""
    from mort_tpu_torch import interactive
    real = interactive.render_wavefront

    def skip(*a, fb=None, layer_range=None, **kw):
        l0 = layer_range[0]
        if l0 % 2 == 1 and fb is not None:
            return fb.reshape(-1, 3) * (l0 + 1) / l0
        return real(*a, fb=fb, layer_range=layer_range, **kw)
    monkeypatch.setattr(interactive, "render_wavefront", skip)
    _no_camera_events(monkeypatch)
    res = drive("mort_scene1.preview", capsys, seconds="2")
    assert res["attempted"] >= 2 and not res["correct"], res["checks"]


def test_preview_altered_answer_fails(monkeypatch, capsys):
    from mort_tpu_torch import interactive
    real = interactive.render_wavefront

    def altered(*a, **kw):
        img = real(*a, **kw).clone()
        img[..., 1] += 0.01
        return img
    monkeypatch.setattr(interactive, "render_wavefront", altered)
    res = drive("mort_scene1.preview", capsys)
    assert not res["correct"], res["checks"]


# --- the fit ----------------------------------------------------------------

def _wrap_step(monkeypatch, fn):
    from mort_tpu_torch.parallel import sharding
    real = sharding.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)
        return lambda *sa, **skw: fn(step, *sa, **skw)
    monkeypatch.setattr(sharding, "make_train_step", make)


def test_fit_state_unchanged_fails(monkeypatch, capsys):
    """The step returns no update: zero gradients."""
    def frozen(step, *a, **kw):
        loss, grads = step(*a, **kw)
        return loss, {k: torch.zeros_like(v) for k, v in grads.items()}
    _wrap_step(monkeypatch, frozen)
    res = drive("mort_scene1.fit", capsys)
    assert not res["correct"], res["checks"]


def test_fit_half_the_pixels_fails(monkeypatch, capsys):
    """Half of the pixels left out, the mean taken over the rest."""
    from mort_tpu_torch.parallel import sharding

    def half(W, H, n):
        wh = (W * H) // 2
        return np.arange(wh, dtype=np.int32), wh
    monkeypatch.setattr(sharding, "_padded_pixels", half)
    res = drive("mort_scene1.fit", capsys)
    assert not res["correct"], res["checks"]


def test_fit_altered_loss_fails(monkeypatch, capsys):
    def altered(step, *a, **kw):
        loss, grads = step(*a, **kw)
        return loss * 1.05, grads
    _wrap_step(monkeypatch, altered)
    res = drive("mort_scene1.fit", capsys)
    assert not res["correct"], res["checks"]
