"""The device mesh (twin of ``repro/launch/mesh.py``), at one rank.

The reference lays a step out over a named grid of devices; the port's
steps run on one device, so its mesh is a description of that one device
with the reference's axis names, which lets a script written against the
reference (``examples/quickstart.py`` builds a ``(1, 1)`` mesh on one
device) say the same thing.  Meshes of more than one rank come with the
distributed train step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-rank mesh: the axis sizes (all 1), their names and the device."""

    shape: dict
    device: torch.device


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``device``; its shape must hold
    one device."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if math.prod(shape) != 1:
        raise NotImplementedError(
            f"mesh {dict(zip(axes, shape))}: the port runs on one rank; meshes of more come with "
            "the distributed train step (ROADMAP queue 1 item 2)")
    return Mesh(shape=dict(zip(axes, shape)), device=resolve_device(device))
