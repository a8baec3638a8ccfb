"""Benchmark: rays/s over the generate+extend+histogram+shade pipeline.

Default mode prints ONE JSON line {"metric", "value", "unit", "vs_baseline",
"platform", "device_kind", "device_count"} for the flagship single-device
configuration: testroomopt.glb (the reference's shipped scene), stratified
generation, the product extend backend (ops/select.py), and the dose shade
— the same work the reference times per iteration (myapp.cpp:166-169:
generate + extend + accumulate per frame).
Iterations run inside ONE jit via lax.scan, as the production launch does,
and each timed window ends in block_until_ready.

Scaling mode (`python bench.py --scaling [--devices N]`, also
`python -m uvtrace bench --scaling`) measures the PRODUCT multi-device path —
Simulator(device_mesh=make_ray_mesh(d)) -> sharded_launch_fn ->
launch_counts — at d = 1, 2, 4, ... devices (weak scaling: constant photons
per device) and prints one JSON row per device count:
{"devices", "rays_per_sec", "rays_per_sec_per_device", "efficiency", ...}
with efficiency = rate_d / (d * rate_1) — the BASELINE multi-device metric
(">= 85% efficiency at 2 hosts").

The bench measures a GPU: without one it exits non-zero. `--platform cpu`
is an explicit rehearsal on 8 virtual CPU devices at small sizes; its rows
say "platform": "cpu" and are no device measurement.

Baseline note: the reference publishes NO throughput numbers (BASELINE.md).
The only quantified performance statement is the requirement "compute the
dosage map within 5 minutes" for 335M photons (Report §1.2) = 1.118 Mrays/s.
`vs_baseline` is measured against that requirement floor; interpret it as
"x times faster than the reference's stated requirement", not vs. a measured
OpenCL run.
"""

import argparse
import json
import os
import sys
import time

REQUIREMENT_RAYS_PER_SEC = 335_544_320 / 300.0  # Report §1.2 floor

# Pinned fixed-seed hit totals of the direct pipeline on testroomopt.glb
# (n = 2^20 stratified rays per iteration, PRNGKey(0) folded with the
# iteration index), keyed by iteration count. Every exact extend backend
# must reproduce them; ±64 per 5 iterations absorbs float-marginal
# hit<->miss flips between compilers.
EXPECTED_HITS = {5: 4_624_808, 20: 18_500_845}
TESTROOM_TRIS = 44866


def _load_scene_mesh():
    from uvtrace.geometry.gltf import load_glb
    from uvtrace.geometry.procedural import make_box_room

    scene_path = os.path.join(os.path.dirname(__file__), "assets", "testroomopt.glb")
    if os.path.exists(scene_path):
        return load_glb(scene_path)
    return make_box_room(subdivisions=60, clutter=40)  # ~44k-tri stand-in


def device_fields() -> dict:
    """What every printed row says about the device it ran on."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
    }


def require_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"bench: no GPU found (JAX platform: {platform}); "
            "pass --platform cpu for a CPU rehearsal"
        )


def direct_pipeline(mesh, n: int):
    """The jitted direct pipeline: run(idx) scans len(idx) iterations of
    n stratified rays (key = fold_in(PRNGKey(0), i)) through extend,
    histogram and shade. Returns (run, backend); run(idx) gives
    (counts int32[T], dose f32[T], dropped) where dropped counts the
    clusters a budgeted backend skipped (0 for exact results)."""
    import jax
    import jax.numpy as jnp

    from uvtrace.ops import accumulate as acc_ops
    from uvtrace.ops import generate as gen_ops
    from uvtrace.ops import shade as shade_ops
    from uvtrace.ops.select import build_extend, resolve_traversal

    backend = resolve_traversal("auto")
    ext = build_extend(mesh.tris, backend)  # budget-free: exact
    t_count = mesh.triangle_count
    lamp = jnp.array([0.0, mesh.floor_height + 0.8, 0.0], jnp.float32)
    areas = jnp.asarray(mesh.areas)

    def one_iter(carry, i):
        counts, dropped = carry
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        rays = gen_ops.generate_stratified(key, n, lamp, 1.0, packet=1024)
        res = ext.fn(ext.scene, rays.orig, rays.dir)
        counts = counts + acc_ops.hit_counts(res[1], t_count, "segment")
        if len(res) > 2:
            dropped = dropped + res[2]
        return (counts, dropped), None

    @jax.jit
    def run(idx):
        init = (jnp.zeros((t_count,), jnp.int32), jnp.zeros((), jnp.int32))
        (counts, dropped), _ = jax.lax.scan(one_iter, init, idx)
        dose = shade_ops.compute_dosage(counts, areas, n * idx.shape[0], 45.0)
        return counts, dose, dropped

    return run, backend


def check_hit_total(total: int, iters: int) -> None:
    """Raise unless `total` (testroom, n = 2^20, `iters` iterations of
    direct_pipeline) matches the pinned total."""
    expected = EXPECTED_HITS[iters]
    tol = 64 * (iters // 5)
    if abs(total - expected) > tol:  # not assert: survives python -O
        raise RuntimeError(
            f"bench hit-count invariant violated: {total} vs {expected} "
            f"(diff {total - expected}) — traversal correctness regression"
        )


def main(n=1 << 20, iters=20, scene_mesh=None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    mesh = scene_mesh if scene_mesh is not None else _load_scene_mesh()
    run, backend = direct_pipeline(mesh, n)
    idx = jnp.arange(iters, dtype=jnp.int32)
    counts, dose, dropped = jax.block_until_ready(run(idx))
    if int(dropped):
        raise RuntimeError(f"bench: the extend backend dropped {int(dropped)} clusters")
    if mesh.triangle_count == TESTROOM_TRIS and n == (1 << 20) and iters in EXPECTED_HITS:
        check_hit_total(int(np.asarray(counts).sum()), iters)

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(idx))
        best = min(best, (time.perf_counter() - t0) / iters)
    rays_per_sec = n / best

    print(
        json.dumps(
            {
                "metric": "rays/sec/device (generate+extend+accumulate+shade, "
                          f"{mesh.triangle_count} tris)",
                "value": round(rays_per_sec, 1),
                "unit": "rays/s",
                "vs_baseline": round(rays_per_sec / REQUIREMENT_RAYS_PER_SEC, 3),
                "backend": backend,
                **device_fields(),
            }
        )
    )


def bounce_row(n=1 << 20, bounces=4, reflectance=0.5, iters=3, scene_mesh=None):
    """4-bounce diffuse+RR throughput through the product Simulator
    (BASELINE config 2). Returns the result-row dict."""
    import jax

    from uvtrace.io.routexml import LightPos
    from uvtrace.sim import SimParams, Simulator

    mesh = scene_mesh if scene_mesh is not None else _load_scene_mesh()
    sim = Simulator(
        mesh,
        SimParams(photon_count=n, max_iterations=iters + 1,
                  max_bounces=bounces, reflectance=reflectance, seed=0),
        route=[LightPos(0.0, 0.0, 1.0)],
        ray_chunk=min(n, 1 << 20),
    )
    sim.run_iteration()  # compile + warmup
    jax.block_until_ready(sim.photon_map)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        sim.run_iteration()
        jax.block_until_ready(sim.photon_map)
        best = min(best, time.perf_counter() - t0)
    segs = sim._launch_n * (1 + bounces)
    return {
        "metric": f"all-segment rays/sec/device ({bounces}-bounce diffuse+RR)",
        "value": round(segs / best, 1),
        "unit": "rays/s",
        "vs_baseline": round(sim._launch_n / best / REQUIREMENT_RAYS_PER_SEC, 3),
        "segments_per_photon": 1 + bounces,
        "backend": sim.backend,
        **device_fields(),
    }


def scaling_rows(device_counts=None, rays_per_device=1 << 20, iters=3, scene_mesh=None):
    """Measure the product sharded path at each device count; returns the
    list of result-row dicts (also usable in-process by tests)."""
    import jax

    from uvtrace.io.routexml import LightPos
    from uvtrace.parallel import make_ray_mesh
    from uvtrace.sim import SimParams, Simulator

    avail = len(jax.devices())
    if not device_counts:  # None or an empty --devices list
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    if max(device_counts) > avail:
        raise SystemExit(
            f"bench --scaling: {max(device_counts)} devices requested, "
            f"{avail} visible; use --platform cpu for a virtual smoke mesh"
        )
    mesh = scene_mesh if scene_mesh is not None else _load_scene_mesh()

    rows = []
    base_per_dev = None
    for d in device_counts:
        sim = Simulator(
            mesh,
            SimParams(
                photon_count=d * rays_per_device,
                max_iterations=iters + 1,
                sampler="stratified",
            ),
            route=[LightPos(0.0, 0.0, 1.0)],
            ray_chunk=min(rays_per_device, 1 << 20),
            device_mesh=make_ray_mesh(d),
        )
        sim.run_iteration()  # compile + warmup
        jax.block_until_ready(sim.photon_map)
        t0 = time.perf_counter()
        for _ in range(iters):
            sim.run_iteration()
        jax.block_until_ready(sim.photon_map)
        dt = (time.perf_counter() - t0) / iters
        rate = sim._launch_n / dt  # photons actually traced per iteration
        per_dev = rate / d
        if base_per_dev is None:
            base_per_dev = per_dev
        rows.append(
            {
                "devices": d,
                "rays_per_sec": round(rate, 1),
                "rays_per_sec_per_device": round(per_dev, 1),
                "efficiency": round(per_dev / base_per_dev, 4),
                "backend": sim.backend,
                **device_fields(),
            }
        )
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="uvtrace throughput benchmark")
    p.add_argument("--scaling", action="store_true",
                   help="multi-device weak-scaling rows via the product "
                        "sharded path (one JSON row per device count)")
    p.add_argument("--bounce", action="store_true",
                   help="4-bounce diffuse+RR all-segment throughput "
                        "(BASELINE config 2) instead of the direct pipeline")
    p.add_argument("--devices", type=int, nargs="*", default=None,
                   metavar="N", help="device counts to measure (default: "
                   "powers of two up to the visible device count)")
    p.add_argument("--rays", type=int, default=None,
                   help="photons per device per iteration (default 2^20)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--platform", choices=["cpu", "gpu"], default="gpu",
                   help="gpu (default) requires a GPU; cpu = an explicit "
                        "rehearsal on 8 virtual CPU devices at small sizes "
                        "(must be the FIRST jax touch in the process)")
    return p.parse_args(argv)


def run_cli(argv=None):
    args = parse_args(argv)
    scene_mesh = None
    rays = args.rays
    if args.platform == "cpu":
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
        )
        if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
            os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
        import jax

        jax.config.update("jax_platforms", "cpu")
        print("platform: cpu (rehearsal; no device measurement)", file=sys.stderr)
        from uvtrace.geometry.procedural import make_box_room

        scene_mesh = make_box_room(subdivisions=8, clutter=4, seed=0)
        rays = rays or (1 << 13)
    else:
        require_gpu()
        rays = rays or (1 << 20)
    from uvtrace.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.scaling:
        for row in scaling_rows(device_counts=args.devices, rays_per_device=rays,
                                iters=args.iters, scene_mesh=scene_mesh):
            print(json.dumps(row))
    elif args.bounce:
        print(json.dumps(bounce_row(n=rays, iters=args.iters, scene_mesh=scene_mesh)))
    else:
        main(n=rays, iters=20 if args.platform == "gpu" else 2, scene_mesh=scene_mesh)


if __name__ == "__main__":
    run_cli()
