"""Device meshes of the distributed stencil layer (the counterpart of the
JAX package's ``launch/mesh.py``).

A ``Mesh`` is a named grid of shards, each placed on a ``torch.device``.
One process drives every shard (the JAX layer is single-controller too:
one program drives every device of a ``shard_map``), so a mesh may hold
more shards than there are cards: with no ``devices`` given, the shards
go on the visible cards in order, the cards repeating when shards
outnumber them, as the JAX package's tests fake host devices in one
process.  It never falls back to the CPU: without a card a mesh needs
``devices`` naming the CPU (what the CPU tests pass).  The LM side's
``make_production_mesh`` is not ported (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_scaling_mesh",
           "mesh_axes"]


class Mesh:
    """Shards on a named grid: ``shape`` is ``{axis: size}`` in axis order,
    ``devices`` the object array of each shard's ``torch.device`` (shape
    the mesh's sizes)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(str(a) for a in axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-axis device array for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """Number of shards."""
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={sorted(set(map(str, self.devices.flat)))})"


def _placement(n: int, devices) -> list:
    """``n`` shard devices: ``devices`` (each a device or its name) or the
    visible cards, in order, repeating when ``n`` outnumbers them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh goes on the GPU by default but torch finds no CUDA "
                "device; pass devices=[torch.device('cpu')] to shard on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return [devices[i % len(devices)] for i in range(n)]


def make_mesh(shape: Sequence[int], names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``shape`` shards over axes ``names`` (the counterpart of
    ``jax.make_mesh``), its shards on ``devices`` or the visible cards in
    order, repeating."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(names)) or min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} for axes {tuple(names)}")
    devs = np.empty(math.prod(shape), dtype=object)
    devs[:] = _placement(math.prod(shape), devices)
    return Mesh(devs.reshape(shape), names)


def make_host_mesh(model: int = 1, devices=None) -> Mesh:
    """A ``(n // model, model)`` mesh over ``("data", "model")``, ``n`` the
    number of ``devices`` (default: the visible cards)."""
    if devices is None:
        devices = _placement(torch.cuda.device_count() or 1, None)
    devices = list(devices)
    return make_mesh((len(devices) // model, model), ("data", "model"), devices)


def make_scaling_mesh(n_devices: int, axis: str = "data", devices=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards over ``axis``: a rung of a weak or
    strong scaling ladder."""
    return make_mesh((int(n_devices),), (axis,), devices)


def mesh_axes(mesh) -> Dict[str, int]:
    """Plain ``{axis name: size}`` view of a mesh, the device-free geometry
    ``core.halo.HaloSpec`` and the cost model take (a mapping passes
    through)."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)
