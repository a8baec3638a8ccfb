"""Multi-host execution (jax.distributed) and the texel/ray 2-D mesh.

The reference is a single-process, single-GPU application; scale-out is a
new-framework deliverable (BASELINE: ">= 85% efficiency at 2 hosts",
config 5: rays+texels sharded over several devices). Design:

- `initialize()` wraps jax.distributed.initialize — call once per process
  before any JAX op, with the coordinator address (`localhost:<port>` on one
  host), the process count and this process's id.
- the global mesh spans all hosts' devices; the `rays` axis carries the
  embarrassingly parallel photon batch, the optional `texels` axis shards
  large dose maps (per-triangle maps are small, but texel-atlas maps at 4K
  resolution are ~16M bins — reduce-scatter over `texels` keeps each
  device's partial bounded while `psum` over `rays` sums the rest).
- collectives: hit-count partials are `psum`ed over `rays`; with a texel
  axis the histogram is computed per texel-shard (each device bins only ids
  in its own range) so the cross-host traffic is one reduce per step.

This module is exercised in-process via
XLA_FLAGS=--xla_force_host_platform_device_count (tests/conftest.py) and by
dryrun_multichip (__graft_entry__.py); real multi-host runs only need
`initialize()` + the same code.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

RAY_AXIS = "rays"
TEXEL_AXIS = "texels"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op if already initialized). Outside a
    cluster manager that advertises them, pass all three arguments."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # only double-initialization is benign; anything else (bad
        # coordinator, port clash) must fail fast, not silently fall back to
        # single-process (it would silently compute 1/N of the photons)
        if "already initialized" not in str(e):
            raise


def make_2d_mesh(ray_shards: Optional[int] = None, texel_shards: int = 1,
                 devices=None) -> Mesh:
    """(rays, texels) mesh over all (global) devices. texel_shards=1 gives
    the plain ray-parallel layout."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if ray_shards is None:
        ray_shards = n // texel_shards
    need = ray_shards * texel_shards
    assert need <= n, (ray_shards, texel_shards, n)
    arr = np.asarray(devices[:need]).reshape(ray_shards, texel_shards)
    return Mesh(arr, (RAY_AXIS, TEXEL_AXIS))


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
