"""The port's mesh: one device.  The reference builds 256- and 512-chip TPU
meshes here; the port runs on one card, so its host mesh has the shape
``{"data": 1, "model": 1}`` and names the device it runs on."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HostMesh:
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": 1, "model": 1}


def make_host_mesh(device) -> HostMesh:
    return HostMesh(torch.device(device))
