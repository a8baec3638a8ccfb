"""uvtrace — a differentiable UV-C disinfection wavefront path tracer in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
C++/OpenCL application `orjfickel/Small-Project-UV-Robot-Ray-Tracer`
(UV-robot dosage simulation: forward photon tracing from a vertical line lamp
into a room mesh, per-triangle dose/irradiance accumulation, heatmap shading,
power calibration, route persistence):

- scene + BVH as flat SoA arrays (geometry/, bvh/)
- wavefront generate/extend/accumulate/shade as plain JAX ops (ops/) —
  deterministic counter-based RNG, order-independent histogram accumulation
  instead of the reference's ``atomic_inc``
- simulation driver with route loop, calibration, view modes (sim/)
- differentiable dose estimator (diff/)
- multi-device sharding via jax.sharding / shard_map (parallel/)
- reference-compatible XML route IO, exports, checkpoints (io/), CLI, viz.

Reference layer map: see SURVEY.md. Reference code is cited by file:line in
docstrings; the implementation here is new.
"""

__version__ = "0.1.0"

from uvtrace.geometry.mesh import TriangleMesh
from uvtrace.bvh.types import FlatBVH
from uvtrace.sim.params import SimParams
