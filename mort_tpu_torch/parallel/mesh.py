"""The device mesh, below the render layer and the train step.

The port is SPMD: one process a device, on ``torch.distributed``'s default
process group, which the caller initialises first (NCCL across cards, gloo
on the CPU or for several ranks that share one card), as the JAX caller
runs ``jax.distributed.initialize``.  ``make_mesh(1)`` needs no process
group.  Every collective of the package goes through ``_all_reduce``,
which counts it, so an entry point can report the collectives it ran.
"""

from __future__ import annotations

import os
import socket
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..device import require_cuda


@dataclass(eq=False)
class Mesh:
    """This rank's view of the device mesh.

    ``axis_names`` ``("rays",)`` or ``("dcn", "ici")`` and ``shape`` (one
    size an axis) as in the JAX package; the shard id is the rank,
    outer-major (rank = dcn index * chips + ici index).  ``groups`` holds
    one process group an axis, outer first (None is the default group), and
    is empty without a process group: then the mesh has one rank and runs
    no collective."""
    axis_names: tuple
    shape: tuple
    rank: int
    device: torch.device
    groups: tuple = ()
    collectives: Counter = field(default_factory=Counter)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def make_mesh(n_devices=None, devices=None, shape=None) -> Mesh:
    """Device mesh for pixel sharding, one rank a device.

    1-D: ``make_mesh(n)`` -> a "rays" axis over the n ranks of the default
    process group (n defaults to its world size); ``make_mesh(1)`` needs no
    process group.  2-D: ``make_mesh(shape=(hosts, chips))`` -> the ("dcn",
    "ici") mesh: rank r is host r // chips, chip r % chips, so every "ici"
    row must lie on one host (torchrun numbers a node's ranks
    contiguously); raises otherwise.

    ``devices``: one ``torch.device`` a rank, indexed by rank (two ranks
    may share a card: ``["cuda:0", "cuda:0"]`` on a gloo group).  The
    default is ``cuda:{LOCAL_RANK}``; it raises where no card is visible,
    so the CPU is taken only when asked (``devices=["cpu"] * n``)."""
    if shape is not None and n_devices is not None:
        raise ValueError("pass n_devices or shape, not both")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise ValueError(f"shape must be (hosts, chips), got {shape}")
        n = shape[0] * shape[1]
    else:
        n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs a process group of {n} ranks, "
            f"one a device; have {world}"
            + ("" if grouped else " (no process group is initialised)"))
    if devices is None:
        require_cuda()
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    else:
        if len(devices) < n:
            raise ValueError(f"{len(devices)} devices for a mesh of {n}")
        device = torch.device(devices[rank])
    if device.type == "cuda":
        # NCCL and all_gather_object act on the current card
        torch.cuda.set_device(device)
    if shape is None:
        return Mesh(("rays",), (n,), rank, device, (None,) if grouped else ())
    hosts, chips = shape
    groups = ()
    if grouped:
        # every rank creates every group, in the same order
        rows = [dist.new_group([h * chips + c for c in range(chips)])
                for h in range(hosts)]
        cols = [dist.new_group([h * chips + c for h in range(hosts)])
                for c in range(chips)]
        groups = (cols[rank % chips], rows[rank // chips])
        names = [None] * world
        dist.all_gather_object(names, socket.gethostname())
        for h in range(hosts):
            row = set(names[h * chips:(h + 1) * chips])
            if len(row) != 1:
                raise ValueError(
                    f"an 'ici' row spans hosts {sorted(row)}; use "
                    f"shape=(hosts, ranks a host) so each row maps to one "
                    f"host's cards")
    return Mesh(("dcn", "ici"), shape, rank, device, groups)


def mesh_axes(mesh: Mesh) -> tuple:
    """The mesh's data-parallel axis names as a flat tuple (outer-major):
    the pixel axis is sharded over every one of them."""
    return tuple(mesh.axis_names)


def check_mesh(mesh, device=None) -> torch.device:
    """``mesh``'s device; raises if ``mesh`` is not a ``Mesh`` or
    ``device`` names another device."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device} on rank {mesh.rank}")
    return mesh.device


def _all_reduce(mesh: Mesh, t: torch.Tensor, what: str) -> int:
    """Sum ``t`` in place over every rank of ``mesh``: over the inner axis
    first, then the outer.  Counts each call in ``mesh.collectives[what]``
    and returns the number run (0 without a process group)."""
    for g in reversed(mesh.groups):
        dist.all_reduce(t, group=g)
        mesh.collectives[what] += 1
    return len(mesh.groups)


def _all_reduce_events(mesh: Mesh | None, device: torch.device):
    """Two timing events that bracket the train step's all-reduce on a card
    whose mesh has process groups (the bucket's ``torch.cat`` to its
    split, on the current stream, which the replay runs on: ``make_mesh``
    makes the mesh's card current), else None: the one-device paths
    record nothing."""
    if mesh is None or not mesh.groups or device.type != "cuda":
        return None
    return tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))


def _padded_pixels(W, H, n_shards):
    WH = W * H
    per = -(-WH // n_shards)
    pix = np.minimum(np.arange(n_shards * per, dtype=np.int32), WH - 1)
    return pix, WH
