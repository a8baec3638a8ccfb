"""Smoke run of uvtrace's product path on a GPU.

    python chip_smoke.py                  # phases 1-6 on one GPU
    python chip_smoke.py --cards 4        # only the sharded config-5 phase, 4 GPUs
    python chip_smoke.py --platform cpu   # rehearsal on the CPU, small photon counts

Every phase runs through the entry points a user calls (uvtrace.cli.main,
Simulator, make_diff_scene) at the deployment's widths: the reference's
scene testroomopt.glb (44,866 triangles), 2^25 photons per iteration and
2^20-ray chunks. Only iterations and optimizer steps are cut, and every cut
is printed. Each phase prints its wall time, the compile time inside it and
the device's peak memory so far; the backend phase prints rays/s of each
plain extend backend.

One process drives the card(s); the only child process is nvidia-smi. The
script exits non-zero without a GPU (unless --platform cpu asks for the
rehearsal), catches no failure, and prints its one-line JSON result last,
only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SCENE = REPO / "assets" / "testroomopt.glb"
CHUNK = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (not assert: survives python -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    log(f"  ok: {what}")


class Phases:
    """Per-phase wall time, compile time (JAX's own compile events) and the
    device's peak memory so far (peak_bytes_in_use is a process maximum)."""

    def __init__(self):
        import jax

        self.compile_s = 0.0

        def on_event(name, secs, **_):
            if name.startswith("/jax/core/compile/"):
                self.compile_s += secs

        jax.monitoring.register_event_duration_secs_listener(on_event)

    @staticmethod
    def peak_bytes():
        import jax

        stats = [d.memory_stats() or {} for d in jax.local_devices()]
        return [s.get("peak_bytes_in_use") for s in stats]

    @contextlib.contextmanager
    def __call__(self, name: str):
        log(f"== phase {name}")
        c0, t0 = self.compile_s, time.perf_counter()
        yield
        log(f"   phase {name}: {time.perf_counter() - t0:.2f} s wall, "
            f"{self.compile_s - c0:.2f} s compiling, "
            f"peak_bytes_in_use {self.peak_bytes()}")


def run_cli(argv: list[str]) -> dict:
    """uvtrace.cli.main in this process; echoes its output and returns
    its JSON result line."""
    from uvtrace.cli import main

    log("   uvtrace " + " ".join(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        log("   | " + line)
    check(rc == 0, f"uvtrace {argv[0]} exited 0")
    return json.loads(out.strip().splitlines()[-1])


def weighted_hits(dose, areas):
    """Per-triangle dose x area: proportional to duration-weighted hits."""
    import numpy as np

    return np.asarray(dose, np.float64) * np.asarray(areas, np.float64)


def expected_coverage(mesh, lamps, rod_base_y, rod_length, photons_per_lamp):
    """Fraction of triangles that a count launch is expected to hit at least
    once: 1 - exp(-sum_lamps n * A_t * E_t / P), with E_t from the
    differentiable estimator (diff/estimator.py, lamp power P = 1)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from uvtrace.diff import irradiance, make_diff_scene

    scene = make_diff_scene(mesh)
    lam = np.zeros(mesh.triangle_count)
    for i, (x, z) in enumerate(lamps):
        e = irradiance(scene, jnp.array([x, z], jnp.float32), rod_base_y, rod_length,
                       1.0, jax.random.PRNGKey(i), n_samples=16)
        lam += photons_per_lamp * np.asarray(mesh.areas, np.float64) * np.asarray(e)
    return float((1.0 - np.exp(-lam)).mean())


def check_coverage(dose, expected, floor=None):
    import numpy as np

    hit = float((np.asarray(dose) > 0).mean())
    log(f"   triangles hit: {hit:.4f}, expected from the estimator {expected:.4f}")
    check(abs(hit - expected) < 0.02, "hit coverage within 0.02 of the estimator's")
    if floor is not None:
        check(hit > floor, f"more than {floor:.0%} of triangles hit")


def phase_parity(mesh, n_rays):
    """Both plain extend backends against the brute-force oracle, and the
    bench's pinned hit total."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from uvtrace.ops.generate import generate_native, generate_stratified
    from uvtrace.ops.intersect import brute_force_closest_hit
    from uvtrace.ops.select import build_extend

    lamp = jnp.array([0.0, mesh.floor_height + 0.8, 0.0], jnp.float32)
    tris = jnp.asarray(mesh.tris)
    rays = {
        "stratified": generate_stratified(jax.random.PRNGKey(11), n_rays, lamp, 1.0),
        "iid": generate_native(jax.random.PRNGKey(12), n_rays, lamp, 1.0),
    }
    oracle = jax.jit(brute_force_closest_hit)
    for backend in ("clustered", "jax"):
        ext = build_extend(mesh.tris, backend)  # budget-free
        fn = jax.jit(ext.fn)
        for kind, r in rays.items():
            t_ref, id_ref = map(np.asarray, oracle(r.orig, r.dir, tris))
            res = fn(ext.scene, r.orig, r.dir)
            t, hit = np.asarray(res[0]), np.asarray(res[1])
            same = float((hit == id_ref).mean())
            log(f"   {backend}/{kind}: {n_rays} rays, {int((id_ref >= 0).sum())} "
                f"oracle hits, ids equal on {same:.6f}")
            check(np.array_equal(hit < 0, id_ref < 0), f"{backend}/{kind} hit/miss masks equal")
            check(bool(np.allclose(t, t_ref, rtol=1e-5, atol=0.0)), f"{backend}/{kind} t within rtol 1e-5")
            check(same >= 0.999, f"{backend}/{kind} triangle ids equal on >= 99.9% of rays")
            if len(res) > 2:
                check(int(res[2]) == 0, f"{backend}/{kind} dropped no clusters")

    run, backend = bench.direct_pipeline(mesh, 1 << 20)
    counts, _, dropped = run(jnp.arange(5, dtype=jnp.int32))
    total = int(np.asarray(counts).sum())
    log(f"   bench gate ({backend}): 5 x 2^20 stratified rays -> {total} hits "
        f"(pinned {bench.EXPECTED_HITS[5]} +- 64)")
    check(int(dropped) == 0, "bench pipeline dropped nothing")
    bench.check_hit_total(total, 5)
    log("  ok: bench hit total")


def phase_backends(mesh, photons):
    """rays/s of each plain backend through Simulator, direct and 4-bounce
    (one 2^20-ray chunk per launch; one warm-up iteration, two timed)."""
    import jax

    from uvtrace.io.routexml import LightPos
    from uvtrace.sim import SimParams, Simulator

    for bounces in (0, 4):
        for backend in ("clustered", "jax"):
            p = SimParams(photon_count=photons, max_iterations=3, max_bounces=bounces,
                          reflectance=0.25 if bounces else 0.0, traversal=backend)
            sim = Simulator(mesh, p, route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=CHUNK)
            sim.run_iteration()
            jax.block_until_ready(sim.photon_map)
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                sim.run_iteration()
                jax.block_until_ready(sim.photon_map)
                times.append(time.perf_counter() - t0)
            segs = sim._launch_n * (1 + bounces)
            log(f"   {backend} {bounces}-bounce: {sim._launch_n} photons/iter, "
                f"iteration s {times}, all-segment rays/s "
                f"{[round(segs / t, 1) for t in times]}")


def phase_config1(tmp, mesh, photons):
    import numpy as np

    log("   cut: 10 iterations -> 2")
    out = Path(tmp) / "c1"
    res = run_cli(["compute", str(SCENE), "--photon-count", str(photons),
                   "--iterations", "2", "--dose-grid", "256", "--no-render",
                   "--output", str(out)])
    dose = np.load(out / "dose_mJ_cm2.npy")
    grid = np.load(out / "dose_grid.npy")
    check(bool(np.isfinite(dose).all() and np.isfinite(grid).all()), "dose and grid finite")
    check(grid.shape == (256, 256) and grid.max() > 0, "256^2 dose grid lit")
    check(res["photons"] == 2 * photons, f"photon accounting exact ({res['photons']})")
    # a static lamp sees about 64% of this scene's triangles, so no fixed
    # floor applies here (config 3's route sees about 90%)
    check_coverage(dose, expected_coverage(mesh, [(0.0, 0.0)], mesh.floor_height + 0.8,
                                           1.0, 2 * photons))
    return weighted_hits(dose, mesh.areas).sum()


def phase_config3(tmp, mesh, small):
    import dataclasses

    import numpy as np

    from uvtrace.io.routexml import load_route_xml
    from uvtrace.sim import SimParams, Simulator, ViewMode

    route_xml = REPO / "assets" / "route.xml"
    route = load_route_xml(route_xml)
    log("   cut: 10 iterations -> 1")
    out = Path(tmp) / "c3"
    argv = ["compute", str(SCENE), "--route", str(route_xml), "--iterations", "1",
            "--no-render", "--output", str(out)]
    photons = route.photon_count
    if small:
        argv += ["--photon-count", str(1 << 14)]
        photons = 1 << 14
    res = run_cli(argv)
    per_lamp = (photons // len(route.waypoints)) & ~1
    chunk = min(CHUNK, 1 << (per_lamp - 1).bit_length())
    want = len(route.waypoints) * -(-per_lamp // chunk) * chunk
    check(res["photons"] == want, f"photon accounting exact ({res['photons']} == {want})")
    dose = np.load(out / "dose_mJ_cm2.npy")
    check(bool(np.isfinite(dose).all()), "dose finite")
    check_coverage(dose, expected_coverage(
        mesh, [(w.x, w.y) for w in route.waypoints],
        mesh.floor_height + route.light_height, route.light_length,
        want // len(route.waypoints),
    ), floor=None if small else 0.8)

    # the golden of tests/test_golden.py::test_golden_testroom_scene, which
    # pins CPU results exactly; on a GPU only float ties may move hits
    params = dataclasses.replace(
        route.apply_to(SimParams(photon_count=1 << 14, max_iterations=2, seed=1234,
                                 light_intensity=450.0, sampler="stratified")),
        photon_count=1 << 14, max_iterations=1, seed=1234,
    )
    sim = Simulator(mesh, params, route=route.waypoints)
    sim.compute()
    got = weighted_hits(sim.dosage_map(ViewMode.DOSAGE), mesh.areas)
    ref = weighted_hits(np.load(REPO / "tests" / "golden" / "testroom_dose.npz")["dose"],
                        mesh.areas)
    rel_total = abs(got.sum() - ref.sum()) / ref.sum()
    l1 = np.abs(got - ref).sum() / ref.sum()
    log(f"   golden: total rel diff {rel_total:.3e}, per-triangle L1 {l1:.3e} of the mass")
    check(rel_total < 1e-4, "golden total hits within 1e-4 relative")
    check(l1 < 0.01, "golden per-triangle L1 < 1% of the mass")


def phase_config2(tmp, mesh, photons, direct_mass):
    import numpy as np

    log("   cut: 10 iterations -> 1")
    out = Path(tmp) / "c2"
    run_cli(["compute", str(SCENE), "--photon-count", str(photons), "--iterations", "1",
             "--bounces", "4", "--reflectance", "0.25", "--no-render",
             "--output", str(out)])
    dose = np.load(out / "dose_mJ_cm2.npy")
    check(bool(np.isfinite(dose).all()), "dose finite")
    mass = weighted_hits(dose, mesh.areas).sum()
    log(f"   hits per photon, area-weighted: 4-bounce {mass:.6g} vs direct {direct_mass:.6g}")
    check(mass > direct_mass, "more hits than direct")


def phase_config4(tmp, mesh, small):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from uvtrace.diff import irradiance, make_diff_scene
    from uvtrace.geometry.procedural import make_box_room

    route = str(REPO / "assets" / "lange_route.xml")
    log("   cut: 100 optimizer steps -> 2, then -> 1 with the bounce term")
    res = run_cli(["optimize-route", str(SCENE), "--route", route, "--steps", "2",
                   "--output", str(Path(tmp) / "opt.xml")])
    check(all(np.isfinite(res[k]) for k in ("final_min_dose", "final_p05_dose",
                                            "final_median_dose")), "optimized doses finite")
    extra = ["--samples", "1", "--sources", "4"] if small else []
    res = run_cli(["optimize-route", str(SCENE), "--route", route, "--steps", "1",
                   "--reflectance", "0.25", "--bounces", "2", "--sources", "64", *extra,
                   "--output", str(Path(tmp) / "opt_bounce.xml")])
    check(bool(np.isfinite(res["final_median_dose"])), "bounce-term optimized dose finite")

    # the same irradiance call on this device and on the host CPU
    cpu = jax.devices("cpu")[0]
    for name, room, tol in (
        ("box room of tests/test_diff.py", make_box_room(subdivisions=4, clutter=1,
                                                         seed=11, floor_y=-1.0), 2e-3),
        ("testroomopt.glb", mesh, None),
    ):
        def irr(room=room):  # every input made under the current default device
            return np.asarray(irradiance(
                make_diff_scene(room), jnp.array([0.3, -0.4]), room.floor_height + 0.8,
                1.0, 450.0, jax.random.PRNGKey(5), n_samples=4,
            ))

        e_dev = irr()
        with jax.default_device(cpu):
            e_cpu = irr()
        off = np.abs(e_dev - e_cpu) > 2e-3 * np.abs(e_cpu) + 1e-6
        log(f"   irradiance {name}: {int(off.sum())} of {off.size} triangles "
            f"differ beyond rtol 2e-3 from the CPU")
        if tol is not None:
            check(not off.any(), f"irradiance on {name} matches the CPU at rtol 2e-3")
        else:
            # one flipped shadow ray moves a triangle's 4-sample estimate by
            # a quarter; float order may flip rays that graze an edge
            check(off.mean() < 1e-3, f"irradiance on {name}: < 0.1% of triangles off")


def phase_gpu_tests(small):
    """The gpu-marked tests, in this process."""
    import pytest

    class Count:
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] = self.n.get(report.outcome, 0) + 1

    os.environ["UVTRACE_TEST_PLATFORM"] = "gpu"
    counter = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-c",
                      str(REPO / "pytest.ini"), str(REPO / "tests" / "test_gpu.py")],
                     plugins=[counter])
    log(f"   gpu-marked tests: {counter.n}")
    check(rc == 0 and counter.n["failed"] == 0, "gpu-marked tests pass")
    if not small:
        check(counter.n["passed"] > 0 and counter.n["skipped"] == 0,
              "every gpu-marked test ran on the GPU")


def phase_four_cards(mesh, photons, chunk):
    """Config 5 sharded over four cards, 1-D and 2-D, against the same
    launch on one card: bit-identical counts."""
    import jax
    import numpy as np

    from uvtrace.parallel import make_2d_mesh, make_ray_mesh
    from uvtrace.sim import SimParams, Simulator

    log("   cut: 10 iterations -> 1")
    params = SimParams(photon_count=photons, max_iterations=1,
                       texel_density=2048.0, texel_max_slots=1 << 25)

    def run(device_mesh):
        sim = Simulator(mesh, params, ray_chunk=chunk, device_mesh=device_mesh)
        t0 = time.perf_counter()
        sim.run_iteration()
        jax.block_until_ready(sim.photon_map_tex)
        log(f"   {'one card' if device_mesh is None else dict(device_mesh.shape)}: "
            f"{sim.backend}, {sim.photon_map_size} photons, {sim.atlas.n_slots} texels, "
            f"{time.perf_counter() - t0:.2f} s (compile included)")
        return sim

    ref = run(None)
    n_slots = ref.atlas.n_slots
    ref_tri, ref_tex = np.asarray(ref.photon_map), np.asarray(ref.photon_map_tex)
    check(ref_tri.sum() > 0 and ref_tex.sum() > 0, "one-card launch deposited dose")
    for name, dm in (("rays:4", make_ray_mesh(4)),
                     ("rays:2 x texels:2", make_2d_mesh(ray_shards=2, texel_shards=2))):
        sim = run(dm)
        tex = np.asarray(sim.photon_map_tex)
        check(np.array_equal(np.asarray(sim.photon_map), ref_tri),
              f"{name}: per-triangle counts bit-identical to one card")
        # a texel axis pads the map to a multiple of its shard count
        check(np.array_equal(tex[:n_slots], ref_tex[:n_slots]) and not tex[n_slots:].any(),
              f"{name}: texel counts bit-identical to one card")
        devs = {s.device for s in sim.photon_map_tex.addressable_shards}
        check(len(devs) == 4, f"{name}: texel map spread over 4 devices")
    peaks = Phases.peak_bytes()
    if all(p is not None for p in peaks):
        check(min(peaks) > 0, f"every card did work (peak bytes {peaks})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=[1, 4], default=1)
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="cpu = rehearsal at small photon counts")
    args = ap.parse_args(argv)
    small = args.platform == "cpu"
    if small:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.cards}")
    import jax

    if small:
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    platform = devices[0].platform
    if platform != args.platform:
        print(f"chip_smoke: needs a GPU, JAX found platform {platform!r} "
              "(--platform cpu runs the CPU rehearsal)", file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} devices, "
              f"found {len(devices)}", file=sys.stderr)
        return 1

    sys.path.insert(0, str(REPO))
    from uvtrace.geometry.gltf import load_glb
    from uvtrace.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if small:
        log("platform: cpu (rehearsal: photon counts cut, no device measurement)")
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        for line in smi.splitlines():
            log(line)
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    photons = (1 << 14) if small else (1 << 25)
    phase = Phases()
    mesh = load_glb(str(SCENE))

    if args.cards == 4:
        with phase("6 config 5 on four cards"):
            # each card scans whole chunks: photons = 4 x chunks per card
            phase_four_cards(mesh, photons, photons // 4 if small else CHUNK)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            with phase("1 extend parity"):
                phase_parity(mesh, (1 << 12) if small else (1 << 14))
            with phase("backends"):
                phase_backends(mesh, photons if small else CHUNK)
            with phase("2 config 1"):
                direct_mass = phase_config1(tmp, mesh, photons)
            with phase("3 config 3"):
                phase_config3(tmp, mesh, small)
            with phase("4 config 2"):
                phase_config2(tmp, mesh, photons, direct_mass)
            with phase("5 config 4"):
                phase_config4(tmp, mesh, small)
            with phase("gpu-marked tests"):
                phase_gpu_tests(small)

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform,
                                             "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
