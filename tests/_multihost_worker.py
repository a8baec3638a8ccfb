"""Worker for the 2-process jax.distributed smoke test (run by
tests/test_multihost.py). Each process contributes 2 virtual CPU devices to a
4-device global mesh and runs ONE product sharded launch
(Simulator(device_mesh=global mesh)); both processes must agree on the
psum'd dose counts — the existence proof of the cross-process path
(uvtrace/parallel/multihost.py; BASELINE ">= 85% at 2 hosts")."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

coordinator, process_id = sys.argv[1], int(sys.argv[2])

import jax

# pin the CPU backend BEFORE distributed init (same as tests/conftest.py)
jax.config.update("jax_platforms", "cpu")

from uvtrace.parallel import multihost

multihost.initialize(
    coordinator_address=coordinator, num_processes=2, process_id=process_id
)

import numpy as np

info = multihost.process_info()
assert info["process_count"] == 2, info
assert info["global_devices"] == 4, info

from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos
from uvtrace.parallel import make_ray_mesh
from uvtrace.sim import SimParams, Simulator

room = make_box_room(subdivisions=3, clutter=1, seed=7)
sim = Simulator(
    room,
    SimParams(photon_count=4096, max_iterations=1),
    route=[LightPos(0.0, 0.0, 1.0)],
    ray_chunk=1024,
    max_clusters=1 << 30,  # full budget: no escalation loop in the smoke test
    device_mesh=make_ray_mesh(),  # ALL global devices (2 local + 2 remote)
)
sim.run_iteration()
counts = np.asarray(sim.photon_map)
total = int(counts.sum())
checksum = int(np.int64((counts * np.arange(1, counts.size + 1)).sum()) % (1 << 31))
print(f"MULTIHOST_OK process={process_id} total={total} checksum={checksum}",
      flush=True)
