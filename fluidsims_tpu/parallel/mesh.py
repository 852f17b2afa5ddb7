"""Device-mesh construction for domain decomposition.

The reference has no distributed computing (SURVEY.md §2: no MPI/NCCL; one
CUDA device).  This framework's scale axis is domain decomposition over a
`jax.sharding.Mesh`: 1-D slab decomposition in x matches the inflow→outflow
anisotropy of the hypersonic domain.  The mesh is a plain device list:
the cards of one host reach each other at the same rate (NVLink, all to
all), so the layout follows the algorithm alone.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

__all__ = ["make_mesh_1d"]


def make_mesh_1d(n_devices: int | None = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    import numpy as np

    return Mesh(np.array(devs[:n_devices]), (axis,))
