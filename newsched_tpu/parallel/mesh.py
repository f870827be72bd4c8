"""Mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis_name: str = "t") -> Mesh:
    """1-D device mesh over the first n devices (default: all). The single
    axis is the time/stream axis; channel sharding reuses it after the
    corner turn (see parallel/channelizer.py docstring). The devices of a
    GPU host are joined all to all, so the mesh follows the algorithm and
    has one axis."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))
