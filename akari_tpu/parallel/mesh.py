"""Device mesh construction for ray-parallel rendering.

New capability vs the reference (single-process, no multi-GPU — its IPC
channel is an empty stub, ref: src/akari/core/ipc.cpp:23-82). SURVEY.md
§2.7/§5.8: the primary parallel axis is the ray/pixel batch ("rays" mesh
axis); scene arrays are replicated; film/loss reductions are psum over
the device interconnect.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_ray_mesh(devices=None, n_devices=None):
    """1-D mesh over all (or the first n) local devices, axis name 'rays'."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("rays",))


def initialize_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-host entry: jax.distributed.initialize passthrough.

    On several hosts this connects processes so that jax.devices() spans
    all hosts and psum crosses them (SURVEY.md §5.8). No-op for a single
    host.
    """
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
