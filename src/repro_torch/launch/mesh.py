"""Device meshes: the one-card host mesh and the production layouts.

A ``Mesh`` names its axes and their sizes.  The host mesh is the
("data", "model") mesh of size (1, 1) over one device: every axis has
size 1, so a sharding spec on it decides a placement and moves nothing,
and ``Mesh.place`` puts a tensor on the device whole.  The production
meshes, (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data",
"model"), are analysis meshes with no devices behind them: the sharding
policy (launch.shardings) and the dry run (launch.dryrun) read their
axis sizes, and anything that would place a tensor on one raises.

make_production_mesh and make_host_mesh are functions (never
module-level state), so importing this module touches no device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    # the devices, an array of ``shape``; None for an analysis mesh
    devices: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def place(self, x: torch.Tensor, spec=None) -> torch.Tensor:
        """``x`` placed by ``spec`` (launch.shardings' form).  On a mesh
        of one device that is the tensor on the device, whole; an
        analysis mesh raises."""
        if self.devices is None:
            raise RuntimeError(
                f"the {'x'.join(map(str, self.shape))} mesh needs "
                f"{self.size} devices and is for analysis only: this "
                f"machine has {torch.cuda.device_count()} CUDA card(s)")
        if self.devices.size != 1:
            raise NotImplementedError(
                f"placing across {self.devices.size} devices is not "
                f"ported; the port runs on one card")
        return x.to(self.devices.flat[0])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, with no devices behind
    it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(device="cuda") -> Mesh:
    """1-device mesh (axes exist, size 1) over ``device``: the card, or
    the CPU when a caller asks for it."""
    devices = np.empty((1, 1), dtype=object)
    devices[0, 0] = resolve(device)
    return Mesh(("data", "model"), (1, 1), devices)


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def data_axes(mesh: Mesh):
    """Axes that jointly shard the batch (pod folds into data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
