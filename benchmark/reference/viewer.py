"""The viewer's camera controls, worked out again from the commands.

W/S move lookfrom and lookat along -w/+w and A/D along -u/+u by one
unit; a mouse drag orbits lookat about lookfrom by -dx/500 radians about
vup, then -dy/500 about u (mort.cu:49-91, vec3.cuh:214-227).  The basis
is taken in float32 and the rotation in float64, as the reference viewer
and the port do.
"""

from __future__ import annotations

import numpy as np

SENSITIVITY = 1.0 / 500.0


def _basis(cam):
    w = cam["lookfrom"] - cam["lookat"]
    w = w / np.linalg.norm(w)
    u = np.cross(cam["vup"], w)
    return u / np.linalg.norm(u), w


def _rotate(vec, axis, theta):
    vec, axis = np.asarray(vec, np.float64), np.asarray(axis, np.float64)
    a_par = (vec @ axis / (axis @ axis)) * axis
    a_ort = vec - a_par
    w = np.cross(axis, a_ort)
    len_ort = np.sqrt(a_ort @ a_ort)
    x1 = np.cos(theta) / len_ort
    x2 = np.sin(theta) / np.sqrt(w @ w)
    return (len_ort * (x1 * a_ort + x2 * w) + a_par).astype(np.float32)


def apply(fields: dict, commands) -> dict:
    """The camera's fields after ``commands`` (('key', k) and ('mouse', dx,
    dy) events; frames leave it as it is)."""
    cam = dict(fields)
    for k in ("lookfrom", "lookat", "vup"):
        cam[k] = np.asarray(cam[k], np.float32)
    for ev in commands:
        if ev[0] == "key":
            u, w = _basis(cam)
            delta = {"w": -w, "s": w, "a": -u, "d": u}[ev[1]]
            cam["lookfrom"] = cam["lookfrom"] + delta.astype(np.float32)
            cam["lookat"] = cam["lookat"] + delta.astype(np.float32)
        elif ev[0] == "mouse":
            u, _ = _basis(cam)
            dx, dy = ev[1], ev[2]
            if dx:
                rot = _rotate(cam["lookat"] - cam["lookfrom"], cam["vup"],
                              -dx * SENSITIVITY)
                cam["lookat"] = cam["lookfrom"] + rot
            if dy:
                rot = _rotate(cam["lookat"] - cam["lookfrom"], u,
                              -dy * SENSITIVITY)
                cam["lookat"] = cam["lookfrom"] + rot
    return cam
