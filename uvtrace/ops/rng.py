"""Random number generation.

Two RNG families:

1. **Reference-semantics RNG** — vectorized WangHash seeding + xorshift32
   streams, matching the reference kernels (cl/tools.cl:2-4) per-photon:
   each photon owns an independent xorshift32 stream seeded by WangHash of its
   thread id and the lamp position (cl/generate.cl:13). Used by the oracle and
   golden tests so photon streams are reproducible against the reference
   algorithm.

2. **Native RNG** — `jax.random` threefry counter-based keys: stateless,
   order-independent, the idiomatic JAX choice for the fast path.

All reference-mode state is explicit (uint32 arrays) — no mutable globals.
The reference's racy cross-launch `SEED` static (cl/generate.cl:6,39 — thread 0
persists its final stream state) is reproduced deterministically by
`advance_global_seed`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

UINT32_TO_UNIT_F32 = np.float32(2.3283064365387e-10)  # 1/(2^32-1), cl/tools.cl:4


def wang_hash(s):
    """WangHash (cl/tools.cl:2), vectorized over uint32 arrays."""
    s = jnp.asarray(s, jnp.uint32)
    s = (s ^ jnp.uint32(61)) ^ (s >> 16)
    s = s * jnp.uint32(9)
    s = s ^ (s >> 4)
    s = s * jnp.uint32(0x27D4EB2D)
    s = s ^ (s >> 15)
    return s


def xorshift32(s):
    """One xorshift32 step (cl/tools.cl:3). Returns the new state (== output)."""
    s = s ^ (s << 13)
    s = s ^ (s >> 17)
    s = s ^ (s << 5)
    return s


def random_float(s):
    """(new_state, f32 in [0,1]) — RandomFloat (cl/tools.cl:4)."""
    s = xorshift32(s)
    return s, s.astype(jnp.float32) * UINT32_TO_UNIT_F32


def f32_to_u32_sat(x):
    """float32 -> uint32 with NVIDIA-style saturation (cvt.rzi.u32.f32).

    The reference seeds with a float expression passed to a uint parameter
    (cl/generate.cl:13); out-of-range conversion is clamped on the GPU the
    reference targeted. Negative -> 0, > 2^32-1 -> 2^32-1, truncation toward 0.
    """
    x = jnp.asarray(x, jnp.float32)
    x = jnp.clip(x, 0.0, np.float32(4294967295.0))
    return x.astype(jnp.uint32)


def photon_seeds(n: int, light_pos, global_seed, start: int = 0):
    """Per-photon seeds for one generate launch (cl/generate.cl:13).

    seed_i = WangHash(f32(i*17 + 1) + x*13 + y*7 + z*11 + f32(global_seed>>15))

    The reference sums an int thread id with float lamp coordinates, promoting
    the whole expression to float32 (left-to-right), then converts to uint.
    We reproduce exactly that (including the f32 precision loss for large i).

    Args:
      n: photons in this launch.
      light_pos: (x, y, z) lamp position (the *3D* position incl. height).
      global_seed: uint32 scalar — the cross-launch SEED value.
      start: first thread id (for sharded launches).
    """
    lp = jnp.asarray(light_pos, jnp.float32)
    x, y, z = lp[0], lp[1], lp[2]
    # `start` may be a traced offset (sharded/chunked launches)
    tid = jnp.arange(n, dtype=jnp.int32) + jnp.asarray(start, jnp.int32)
    acc = (tid * 17 + 1).astype(jnp.float32)
    acc = acc + x * jnp.float32(13)
    acc = acc + y * jnp.float32(7)
    acc = acc + z * jnp.float32(11)
    acc = acc + (jnp.uint32(global_seed) >> 15).astype(jnp.float32)
    return wang_hash(f32_to_u32_sat(acc))


def advance_global_seed(light_pos, global_seed):
    """Deterministic replay of the reference's cross-launch SEED update.

    cl/generate.cl:39: after each launch, thread 0 stores its final stream
    state into the static SEED. Thread 0's consumption is deterministic:
    1 float for the rod height, 1 for dir-y, plus 2 per rejection-sampling
    round until the disc sample is accepted (cl/generate.cl:16-29).
    """
    s = photon_seeds(1, light_pos, global_seed)[0]
    s, _ = random_float(s)  # rod height
    s, _ = random_float(s)  # dir y
    def cond(carry):
        s, dx, dz, first = carry
        return jnp.logical_or(first, dx * dx + dz * dz > 1.0)
    def body(carry):
        s, _, _, _ = carry
        s, ux = random_float(s)
        s, uz = random_float(s)
        return s, ux * 2 - 1, uz * 2 - 1, jnp.bool_(False)
    s, _, _, _ = jax.lax.while_loop(
        cond, body, (s, jnp.float32(0), jnp.float32(0), jnp.bool_(True))
    )
    return s
