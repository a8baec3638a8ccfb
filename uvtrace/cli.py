"""Headless CLI — replaces the reference's ImGui/OpenGL interaction layer
(userinterface.cpp / myapp.cpp) with batch commands (SURVEY.md §7):

  python -m uvtrace info    <scene.glb>
  python -m uvtrace compute <scene.glb> [--route route.xml] [...]
  python -m uvtrace calibrate <scene.glb> --measure-power 2909 [...]
  python -m uvtrace optimize-route <scene.glb> --route route.xml [...]
  python -m uvtrace render  <scene.glb> --checkpoint state.npz [...]
  python -m uvtrace bench

Every parameter the reference UI exposes (power, lamp length/height, photon
count, iterations, min dose/irradiance, view modes, threshold view,
calibration modal defaults — userinterface.cpp:42-408) has a flag here.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

from uvtrace.ops.select import TRAVERSALS


class CLIError(Exception):
    """Fail-fast user-facing error: one actionable line, nonzero exit —
    the role of the reference's FatalError popups and CheckCL error
    translation (template/template.cpp:525+, :555+)."""


@contextlib.contextmanager
def _translated(what: str, path):
    """Translate loader failures (missing file, bad magic, malformed XML,
    corrupt npz) into a CLIError naming the file and the problem."""
    try:
        yield
    except CLIError:
        raise
    except FileNotFoundError:
        raise CLIError(f"{what} not found: {path}") from None
    except IsADirectoryError:
        raise CLIError(f"{what} is a directory, expected a file: {path}") from None
    except PermissionError:
        raise CLIError(f"{what} not readable (permission denied): {path}") from None
    except Exception as e:  # ValueError (bad GLB), ET.ParseError, zipfile ...
        detail = str(e).strip() or type(e).__name__
        raise CLIError(f"cannot read {what} '{path}': {detail}") from None


def _load_mesh(path: str):
    from uvtrace.geometry.gltf import load_glb

    with _translated("scene", path):
        return load_glb(path)


def _apply_param_flags(params, args):
    import dataclasses

    override = {}
    for field in [
        "photon_count",
        "max_iterations",
        "light_intensity",
        "light_length",
        "light_height",
        "min_dosage",
        "min_power",
        "sampler",
        "traversal",
        "max_bounces",
        "reflectance",
        "seed",
        "texel_density",
        "texel_max_slots",
    ]:
        v = getattr(args, field, None)
        if v is not None:
            override[field] = v
    return dataclasses.replace(params, **override)


def _add_param_flags(p):
    p.add_argument("--photon-count", dest="photon_count", type=int)
    p.add_argument("--iterations", dest="max_iterations", type=int)
    p.add_argument("--power", dest="light_intensity", type=float)
    p.add_argument("--lamp-length", dest="light_length", type=float)
    p.add_argument("--lamp-height", dest="light_height", type=float)
    p.add_argument("--min-dosage", dest="min_dosage", type=float)
    p.add_argument("--min-power", dest="min_power", type=float)
    p.add_argument("--sampler", choices=["native", "stratified", "reference"])
    p.add_argument("--traversal", choices=TRAVERSALS,
                   help="extend backend (auto: ops/select.py)")
    p.add_argument("--bounces", dest="max_bounces", type=int)
    p.add_argument("--reflectance", type=float)
    p.add_argument("--seed", type=int)
    p.add_argument("--route", type=str, help="route XML (reference schema)")
    p.add_argument("--shards", type=int, default=0, metavar="N",
                   help="shard every launch over N devices (ray-axis "
                        "shard_map + psum; 0 = single device, -1 = all "
                        "visible devices). Results are bit-identical to the "
                        "single-device run.")
    p.add_argument("--texel-shards", dest="texel_shards", type=int, default=1,
                   metavar="M",
                   help="also shard the texel dose map over M devices "
                        "(2-D rays x texels mesh; requires --texel-density; "
                        "BASELINE config 5). Total devices = shards.")
    p.add_argument("--texel-density", dest="texel_density", type=float,
                   metavar="PER_M",
                   help="texels per meter for sub-triangle dose maps "
                        "(0 = per-triangle only; ops/texel.py)")
    p.add_argument("--texel-max-slots", dest="texel_max_slots", type=int,
                   metavar="N", help="texel atlas budget (default 2^22)")


def _ray_mesh_from_args(args):
    """--shards N -> a 1-D ('rays',) device mesh; N < 0 = all visible
    devices; 0/absent = None (single device). Single source of truth for
    the shard-count convention across compute/optimize-route/dose-image."""
    shards = getattr(args, "shards", 0) or 0
    if not shards:
        return None
    from uvtrace.parallel import make_ray_mesh

    return make_ray_mesh(None if shards < 0 else shards)


def _build_sim(args):
    import numpy as np

    from uvtrace.io.routexml import load_route_xml
    from uvtrace.sim import SimParams, Simulator

    mesh = _load_mesh(args.scene)
    params = SimParams()
    route = None
    if args.route:
        with _translated("route XML", args.route):
            r = load_route_xml(args.route)
        params = r.apply_to(params)
        route = r.waypoints
    params = _apply_param_flags(params, args)
    device_mesh = None
    shards = getattr(args, "shards", 0) or 0
    tex_shards = getattr(args, "texel_shards", 1) or 1
    if tex_shards > 1:
        # 2-D (rays x texels) mesh — the config-5 layout
        import jax

        from uvtrace.parallel import make_2d_mesh

        total = len(jax.devices()) if shards <= 0 else shards
        if total % tex_shards:
            raise CLIError(
                f"--shards {total} is not divisible by --texel-shards {tex_shards}"
            )
        device_mesh = make_2d_mesh(
            ray_shards=total // tex_shards, texel_shards=tex_shards
        )
    else:
        device_mesh = _ray_mesh_from_args(args)
    try:
        sim = Simulator(mesh, params, route=route, device_mesh=device_mesh)
    except ValueError as e:  # bad flag combination (e.g. texel axis w/o atlas)
        raise CLIError(str(e)) from None
    return mesh, sim


def cmd_info(args):
    mesh = _load_mesh(args.scene)
    lo, hi = mesh.aabb
    print(f"scene: {mesh.name}")
    print(f"triangles: {mesh.triangle_count}")  # mesh.cpp:94-96 prints the same
    print(f"floor height: {mesh.floor_height:.4f} m")
    print(f"aabb: {lo.round(3).tolist()} .. {hi.round(3).tolist()}")
    print(f"surface area: {mesh.areas.sum():.2f} m^2")
    if getattr(args, "texel_max_slots", None) and not getattr(args, "texel_density", None):
        raise CLIError("--texel-max-slots requires --texel-density")
    if getattr(args, "texel_density", None):
        import numpy as np

        from uvtrace.ops.texel import build_atlas

        kw = {}
        if getattr(args, "texel_max_slots", None):
            kw["max_slots"] = args.texel_max_slots
        atlas = build_atlas(mesh.areas, density=args.texel_density, **kw)
        k = np.asarray(atlas.k)
        print(
            f"texel atlas @ {args.texel_density}/m: {atlas.n_slots} slots "
            f"(k min {k.min()} / median {int(np.median(k))} / max {k.max()}; "
            f"{atlas.n_slots * 4 / 1e6:.1f} MB per accumulator)"
        )
    return 0


def cmd_compute(args):
    import numpy as np

    from uvtrace.io.checkpoint import save_checkpoint
    from uvtrace.io.export import export_dose_npy, export_heatmap_png, export_legend_png
    from uvtrace.sim import ViewMode
    from uvtrace.utils.timing import ProgressReporter

    mesh, sim = _build_sim(args)
    if args.resume:
        # cross-process "Resume computation" (userinterface.cpp:339-344):
        # restore accumulators + RNG + iteration counter and continue on top
        from uvtrace.io.checkpoint import load_checkpoint

        with _translated("checkpoint", args.resume):
            load_checkpoint(args.resume, sim)
        # CLI flags override checkpointed parameters (e.g. --iterations to
        # extend the run, exactly like the UI's editable iteration count)
        sim.params = _apply_param_flags(sim.params, args)
        sim.finished = sim.curr_iterations >= sim.params.max_iterations
    profile = getattr(args, "profile", None)
    reporter = ProgressReporter(sim.params.max_iterations)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    marker_kw = dict(
        route=None if args.no_markers else sim.route,
        floor_height=mesh.floor_height,
        light_height=sim.params.light_height,
        light_length=sim.params.light_length,
        gamma=args.gamma,
    )

    def _run():
        while not sim.finished:
            sim.run_iteration()
            reporter.update(sim.curr_iterations, sim.photon_map_size)
            if args.watch:
                # live view of the evolving heatmap, refreshed per iteration
                # (the reference redraws every frame, myapp.cpp:156-177)
                export_heatmap_png(
                    out / "dose_live.png", mesh.tris,
                    sim.dosage_map(ViewMode.DOSAGE), sim.params.min_dosage,
                    args.threshold_view, **marker_kw,
                )

    if profile:
        from uvtrace.utils.timing import device_trace

        with device_trace(profile):
            _run()
    else:
        _run()
    dose = sim.dosage_map(ViewMode.DOSAGE)
    irr = sim.dosage_map(ViewMode.MAX_POWER)
    export_dose_npy(out / "dose_mJ_cm2.npy", dose)
    export_dose_npy(out / "irradiance_uW_cm2.npy", irr)
    tex_stats = {}
    if sim.atlas is not None:
        # sub-triangle dose maps are a deliverable, not an internal array:
        # per-texel doses + the atlas layout that maps slot -> (triangle,
        # barycentric cell) so external tools can consume them
        tex_dose = np.asarray(sim.dosage_map_texels(ViewMode.DOSAGE))
        export_dose_npy(out / "dose_texels.npy", tex_dose)
        export_dose_npy(
            out / "irradiance_texels.npy",
            sim.dosage_map_texels(ViewMode.MAX_POWER),
        )
        np.savez_compressed(
            out / "texel_atlas.npz",
            base=np.asarray(sim.atlas.base),
            k=np.asarray(sim.atlas.k),
            cell_area=np.asarray(sim.atlas.cell_area),
        )
        tex_stats = {
            "texels": sim.atlas.n_slots,
            "tex_dose_max": float(tex_dose.max()),
            "tex_dose_mean": float(tex_dose.mean()),
            "tex_dose_min": float(tex_dose.min()),
            "tex_coverage_above_min": float(
                (tex_dose >= sim.params.min_dosage).mean()
            ),
        }
        if not args.no_render or args.export_glb:
            # bake the atlas texture ONCE (a host-side loop over every
            # triangle — seconds at 16M slots) and feed both deliverables:
            # the texel-resolution camera render and the dose-textured .glb
            # (dose -> color -> screen closed at sub-triangle detail; the
            # reference's end-to-end path, cl/shade.cl:61-70, is per-tri)
            from uvtrace.geometry.mesh import TriangleMesh
            from uvtrace.io.texel_bake import bake_texel_atlas

            image, uvs = bake_texel_atlas(
                sim.atlas, tex_dose, sim.params.min_dosage, args.threshold_view
            )
        if not args.no_render:
            from uvtrace.io.png import write_png
            from uvtrace.viz.rasterizer import render_textured

            baked = TriangleMesh(tris=mesh.tris, uvs=uvs, texture=image)
            write_png(
                out / "dose_texels.png",
                render_textured(baked, width=960, height=720, gamma=args.gamma),
            )
        if args.export_glb:
            from uvtrace.io.gltf_export import export_glb as _export_glb
            from uvtrace.io.png import png_bytes

            _export_glb(
                out / "dose_texels.glb", mesh.tris, uvs=uvs,
                texture_png=png_bytes(image),
            )
    if not args.no_render:
        export_heatmap_png(
            out / "dose.png", mesh.tris, dose, sim.params.min_dosage,
            args.threshold_view, **marker_kw,
        )
        export_heatmap_png(
            out / "irradiance.png", mesh.tris, irr, sim.params.min_power,
            args.threshold_view, **marker_kw,
        )
        export_legend_png(out / "legend.png", sim.params.min_dosage)
    if args.export_glb:
        sim.export_glb(out / "dose.glb", ViewMode.DOSAGE, args.threshold_view)
    if args.checkpoint:
        save_checkpoint(out / "checkpoint.npz", sim)
    # the reference auto-saves route+parameters on shutdown and before every
    # recompute (myapp.cpp:298, raytracer.cpp:126); the equivalent artifact
    # records exactly what was computed
    sim.save_route(out / "route_used.xml")
    if args.dose_grid:
        from uvtrace.io.export import export_grid_png

        grid = sim.dose_grid(res=args.dose_grid)
        np.save(out / "dose_grid.npy", grid)
        export_grid_png(out / "dose_grid.png", grid, sim.params.min_dosage,
                        args.threshold_view, gamma=args.gamma,
                        route=None if args.no_markers else sim.route,
                        aabb=mesh.aabb)
    d = np.asarray(dose)
    from uvtrace.i18n import tr

    print(f"{tr('computing')}: {tr('done')}")
    print(
        json.dumps(
            {
                "photons": sim.photon_map_size,
                "dose_max": float(d.max()),
                "dose_mean": float(d.mean()),
                "dose_min": float(d.min()),
                "coverage_above_min": float((d >= sim.params.min_dosage).mean()),
                **tex_stats,
                "output": str(out),
            }
        )
    )
    return 0


def cmd_calibrate(args):
    mesh, sim = _build_sim(args)
    power = sim.calibrate_power(args.measure_power, args.measure_height, args.measure_dist)
    print(json.dumps({"calibrated_power_W": power}))
    return 0


def cmd_optimize_route(args):
    import numpy as np

    from uvtrace.diff import make_diff_scene, optimize_route
    from uvtrace.io.routexml import LightPos, Route, load_route_xml, save_route_xml
    from uvtrace.sim import SimParams

    mesh = _load_mesh(args.scene)
    with _translated("route XML", args.route):
        r = load_route_xml(args.route)
    params = _apply_param_flags(r.apply_to(SimParams()), args)
    # shadow rays shard over the mesh's ray axis exactly like compute
    # launches (diff/estimator._shard_extend; bit-identical results)
    scene = make_diff_scene(mesh, device_mesh=_ray_mesh_from_args(args))
    wp = np.array([[w.x, w.y] for w in r.waypoints], np.float32)
    durs = np.array([w.duration for w in r.waypoints], np.float32)
    lo, hi = mesh.aabb
    # keep waypoints inside the room footprint (with a margin so the lamp
    # does not sit in a wall); --no-bounds disables
    bounds = None
    if not args.no_bounds:
        m = 0.1
        bounds = ((float(lo[0]) + m, float(lo[2]) + m),
                  (float(hi[0]) - m, float(hi[2]) - m))
        wp0 = wp
        wp = np.clip(wp, np.float32(bounds[0]) + 1e-3, np.float32(bounds[1]) - 1e-3)
        moved = np.where(np.abs(wp - wp0).max(axis=1) > 1e-6)[0]
        if moved.size:
            # a route with waypoints intentionally outside the scanned AABB
            # (doorway, alcove) must not be moved silently
            print(
                f"uvtrace: note: clipped waypoint(s) "
                f"{', '.join(str(i) for i in moved)} into the scene footprint "
                f"(use --no-bounds to optimize outside the AABB)",
                file=sys.stderr,
            )
    target_mask = None
    if args.exclude_ceiling:
        # the ceiling is unreachable-by-design dose area (the lamp points
        # sideways/down in practice); leaving it in the softmin objective
        # lets permanently-dark roof triangles pin the min at ~0. Height
        # band like dose_grid's skip_ceiling (documented caveat applies),
        # including its flat-scene guard: a roofless scan where the band
        # would swallow every triangle (empty objective -> -inf loss and a
        # zero-size reduction at the end) keeps the full mask instead.
        margin = 0.05
        cy = np.asarray(mesh.tris)[:, :, 1].mean(axis=1)
        if float(hi[1] - lo[1]) <= 10 * margin:
            print("uvtrace: note: --exclude-ceiling skipped (flat scene — "
                  "no roof band to exclude)", file=sys.stderr)
        else:
            target_mask = cy < float(hi[1]) - margin
            if not target_mask.any():
                raise CLIError(
                    "--exclude-ceiling would exclude every triangle — "
                    "the scene appears to be a single horizontal band"
                )
            print(
                f"uvtrace: note: excluding {int((~target_mask).sum())} "
                "ceiling-band triangles from the objective",
                file=sys.stderr,
            )
    bounce_kw = {}
    if params.reflectance > 0:
        # --reflectance/--bounces reach the differentiable objective: the
        # optimized route then accounts for interreflected dose the way the
        # forward bounce simulator does (BASELINE configs 2+4 jointly)
        if params.max_bounces < 1:
            # a forward `compute --reflectance X` without --bounces traces
            # ZERO bounce segments; silently flooring to 1 here would make
            # the optimized objective claim dose the forward run cannot
            # reproduce — say so
            print(
                "uvtrace: note: --reflectance without --bounces optimizes "
                "a 1-bounce objective; pass --bounces N (and use the same "
                "flags in `compute`) to match a forward bounce run",
                file=sys.stderr,
            )
        bounce_kw = dict(
            reflectance=params.reflectance,
            areas=np.asarray(mesh.areas),
            n_bounces=max(1, params.max_bounces),
            n_sources=args.sources,
        )
    from uvtrace.utils.timing import Timer

    step_timer = Timer()

    def step_progress(i, loss):
        # seconds since the previous step; step 0 includes the compile
        print(f"step {i}: loss {loss:.4f} ({step_timer.elapsed():.3f} s)", file=sys.stderr)
        step_timer.reset()

    res = optimize_route(
        scene,
        wp,
        durs,
        mesh.floor_height + params.light_height,
        params.light_length,
        params.light_intensity,
        steps=args.steps,
        learning_rate=args.lr,
        n_samples=args.samples,
        bounds=bounds,
        progress=step_progress,
        target_mask=target_mask,
        **bounce_kw,
    )
    out_route = Route(
        waypoints=[
            LightPos(float(x), float(y), float(d))
            for (x, y), d in zip(res.waypoints_xz, res.durations)
        ],
        photon_count=params.photon_count,
        max_iterations=params.max_iterations,
        light_intensity=params.light_intensity,
        min_dosage=params.min_dosage,
        min_power=params.min_power,
        light_length=params.light_length,
        light_height=params.light_height,
    )
    save_route_xml(args.output, out_route)
    d = res.final_dose_masked
    print(json.dumps({
        "final_min_dose": res.final_min_dose,
        # real scans contain unreachable triangles (inside furniture) that
        # pin the raw min at 0 — percentiles/coverage carry the progress
        "final_p05_dose": float(np.percentile(d, 5)),
        "final_median_dose": float(np.median(d)),
        "coverage_above_min": float((d >= params.min_dosage).mean()),
        "output": args.output,
    }))
    return 0


def cmd_dose_image(args):
    """Differentiable dose image + gradients as artifacts (BASELINE
    north-star "pixel gradients"): writes the res x res image, its PNG, and
    the gradient of the worst-pixel objective (softmin over lit pixels)
    w.r.t. every waypoint position and dwell time — "which way should each
    lamp stop move to lift the darkest spot"."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from uvtrace.diff import dose_image, make_diff_scene, plan_dose_image
    from uvtrace.diff.optimize import softmin
    from uvtrace.io.export import export_grid_png
    from uvtrace.io.routexml import load_route_xml
    from uvtrace.sim import SimParams

    if not args.route:
        raise CLIError("dose-image needs --route (the image differentiates "
                       "w.r.t. its waypoints)")
    mesh = _load_mesh(args.scene)
    with _translated("route XML", args.route):
        r = load_route_xml(args.route)
    params = _apply_param_flags(r.apply_to(SimParams()), args)
    scene = make_diff_scene(mesh, device_mesh=_ray_mesh_from_args(args))
    plan = plan_dose_image(scene, res=args.res)
    wp = jnp.asarray([[w.x, w.y] for w in r.waypoints], jnp.float32)
    durs = jnp.asarray([w.duration for w in r.waypoints], jnp.float32)
    key = jax.random.PRNGKey(params.seed)
    kw = dict(n_samples=args.samples)
    if params.reflectance > 0:
        if params.max_bounces < 1:
            print(
                "uvtrace: note: --reflectance without --bounces renders a "
                "1-bounce image; pass --bounces N to match a forward "
                "bounce run",
                file=sys.stderr,
            )
        kw.update(
            reflectance=params.reflectance, areas=jnp.asarray(mesh.areas),
            n_bounces=max(1, params.max_bounces), n_sources=args.sources,
        )

    def image_of(wp, durs):
        return dose_image(
            scene, plan, wp, durs, mesh.floor_height + params.light_height,
            params.light_length, params.light_intensity, key, **kw,
        )

    def worst_pixel(wp_durs):
        img = image_of(*wp_durs).ravel()
        lit = plan.mask & (img > 0)
        # softmin over lit pixels only: misses park at a huge dose so their
        # exp(-x/T) weight is exactly 0 (an inf would NaN the logsumexp)
        return softmin(jnp.where(lit, img, 1e9), 5.0)

    img = np.asarray(image_of(wp, durs))
    (g_wp, g_durs) = jax.grad(worst_pixel)((wp, durs))
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "dose_image.npy", img)
    export_grid_png(out / "dose_image.png", img, params.min_dosage,
                    args.threshold_view, aabb=mesh.aabb,
                    route=r.waypoints)
    np.savez(out / "gradients.npz",
             d_worstdose_d_waypoints=np.asarray(g_wp),
             d_worstdose_d_durations=np.asarray(g_durs))
    print(json.dumps({
        "res": args.res,
        "dose_max": float(img.max()),
        "worst_lit_pixel": float(img[img > 0].min()) if (img > 0).any() else 0.0,
        "waypoint_grad_norms": [round(float(n), 6) for n in
                                np.linalg.norm(np.asarray(g_wp), axis=1)],
        "output": str(out),
    }))
    return 0


def cmd_render(args):
    import jax.numpy as jnp
    import numpy as np

    from uvtrace.io.checkpoint import load_checkpoint, peek_params
    from uvtrace.io.export import export_heatmap_png
    from uvtrace.sim import SimParams, Simulator, ViewMode
    from uvtrace.viz.camera import Camera

    mesh = _load_mesh(args.scene)
    # adopt the checkpointed run's parameters (texel_density in particular:
    # the atlas must exist at construction for the texel state to restore)
    with _translated("checkpoint", args.checkpoint):
        params = peek_params(args.checkpoint)
    sim = Simulator(mesh, params)
    with _translated("checkpoint", args.checkpoint):
        load_checkpoint(args.checkpoint, sim)
    camera = None
    if args.camera:
        with _translated("camera XML", args.camera):
            camera = Camera.load_xml(args.camera)
    if args.view == "texture":
        # photo-scan view (ViewMode::texture, myapp.cpp:186-194): per-pixel
        # perspective-correct UV sampling of the scan texture
        from uvtrace.io.png import write_png
        from uvtrace.viz.rasterizer import render_textured

        img = render_textured(mesh, camera=camera)
        write_png(args.output, img)
        print(json.dumps({"output": args.output}))
        return 0
    view = ViewMode.MAX_POWER if args.view == "maxpower" else ViewMode.DOSAGE
    scale = sim.params.min_power if view == ViewMode.MAX_POWER else sim.params.min_dosage
    if sim.atlas is not None:
        # texel runs render at texel resolution (sub-triangle dose)
        from uvtrace.io.texel_bake import export_texel_heatmap_png

        export_texel_heatmap_png(
            args.output, mesh.tris, sim.atlas,
            sim.dosage_map_texels(view), scale, args.threshold_view,
            camera=camera,
        )
    else:
        export_heatmap_png(
            args.output, mesh.tris, sim.dosage_map(view), scale,
            args.threshold_view, camera=camera,
        )
    print(json.dumps({"output": args.output}))
    return 0


def cmd_bench(args):
    import bench

    argv = []
    if args.scaling:
        argv.append("--scaling")
    if args.bounce:
        argv.append("--bounce")
    if args.devices is not None:
        argv += ["--devices", *map(str, args.devices)]
    if args.rays is not None:
        argv += ["--rays", str(args.rays)]
    argv += ["--iters", str(args.iters)]
    if args.platform:
        argv += ["--platform", args.platform]
    bench.run_cli(argv)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="uvtrace", description=__doc__)
    p.add_argument("--lang", choices=["en", "nl"], default="en",
                   help="output language (the reference UI is bilingual EN/NL)")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("info", help="scene statistics")
    pi.add_argument("scene")
    pi.add_argument("--texel-density", dest="texel_density", type=float,
                    metavar="PER_M",
                    help="also report the texel atlas this density would "
                         "allocate (slots, per-tri grid sizes, memory)")
    pi.add_argument("--texel-max-slots", dest="texel_max_slots", type=int,
                    metavar="N")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("compute", help="compute the dosage map")
    pc.add_argument("scene")
    _add_param_flags(pc)
    pc.add_argument("--output", default="out")
    pc.add_argument("--threshold-view", action="store_true")
    pc.add_argument("--no-render", action="store_true")
    pc.add_argument("--export-glb", action="store_true",
                    help="write a dose-colored .glb for external viewers")
    pc.add_argument("--checkpoint", action="store_true")
    pc.add_argument("--resume", metavar="CKPT",
                    help="resume accumulation from a checkpoint.npz")
    pc.add_argument("--profile", metavar="DIR",
                    help="write a jax.profiler device trace to DIR")
    pc.add_argument("--dose-grid", type=int, default=0, metavar="RES",
                    help="also write a RES x RES top-down dose image "
                         "(BASELINE config 1: 256)")
    pc.add_argument("--watch", action="store_true",
                    help="re-export the heatmap after every iteration "
                         "(dose_live.png — the reference redraws per frame, "
                         "myapp.cpp:156-177)")
    pc.add_argument("--no-markers", action="store_true",
                    help="hide the route waypoint markers (the reference's "
                         "'show lights' toggle, myapp.cpp:143-153)")
    pc.add_argument("--gamma", action="store_true",
                    help="sqrt gamma-encode PNG output (the reference ships "
                         "with this commented out, template.cpp:159)")
    pc.set_defaults(fn=cmd_compute)

    pk = sub.add_parser("calibrate", help="calibrate lamp power vs a UV-meter reading")
    pk.add_argument("scene")
    _add_param_flags(pk)
    pk.add_argument("--measure-power", type=float, required=True, help="µW/cm^2")
    pk.add_argument("--measure-height", type=float, default=0.8, help="m")
    pk.add_argument("--measure-dist", type=float, default=1.0, help="m")
    pk.set_defaults(fn=cmd_calibrate)

    po = sub.add_parser("optimize-route", help="gradient-optimize route waypoints")
    po.add_argument("scene")
    _add_param_flags(po)
    po.add_argument("--steps", type=int, default=100)
    po.add_argument("--lr", type=float, default=0.05)
    po.add_argument("--samples", type=int, default=4)
    po.add_argument("--sources", type=int, default=64,
                    help="bounce-estimator source points (with --reflectance)")
    po.add_argument("--exclude-ceiling", action="store_true",
                    help="drop ceiling-band triangles from the min-dose "
                         "objective (unreachable roof area otherwise pins "
                         "the softmin near 0)")
    po.add_argument("--no-bounds", action="store_true",
                    help="allow waypoints outside the room footprint "
                         "(default: box-constrained to the scene AABB)")
    po.add_argument("--output", default="route_optimized.xml")
    po.set_defaults(fn=cmd_optimize_route)

    pg = sub.add_parser(
        "dose-image",
        help="differentiable dose image + waypoint gradients (pixel-"
             "gradient deliverable; diff/image.py)",
    )
    pg.add_argument("scene")
    _add_param_flags(pg)
    pg.add_argument("--res", type=int, default=128)
    pg.add_argument("--samples", type=int, default=8)
    pg.add_argument("--sources", type=int, default=64,
                    help="bounce-estimator source points (with --reflectance)")
    pg.add_argument("--threshold-view", action="store_true")
    pg.add_argument("--output", default="out")
    pg.set_defaults(fn=cmd_dose_image)

    pr = sub.add_parser("render", help="render a checkpointed dose map to PNG")
    pr.add_argument("scene")
    pr.add_argument("--checkpoint", required=True)
    pr.add_argument("--camera", help="camera.xml (reference schema)")
    pr.add_argument("--view", choices=["dosage", "maxpower", "texture"], default="dosage")
    pr.add_argument("--threshold-view", action="store_true")
    pr.add_argument("--output", default="render.png")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser(
        "bench",
        help="throughput benchmark (one JSON line; --scaling: one JSON row "
             "per device count via the product sharded path)",
    )
    pb.add_argument("--scaling", action="store_true")
    pb.add_argument("--bounce", action="store_true",
                    help="4-bounce all-segment throughput (config 2)")
    pb.add_argument("--devices", type=int, nargs="*", default=None, metavar="N")
    pb.add_argument("--rays", type=int, default=None,
                    help="photons per device per iteration")
    pb.add_argument("--iters", type=int, default=3)
    pb.add_argument("--platform", choices=["cpu", "gpu"], default=None)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from uvtrace.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from uvtrace.i18n import set_language, tr

    set_language(args.lang)
    try:
        return args.fn(args)
    except CLIError as e:
        # fail fast with one actionable line (FatalError, template.cpp:525+)
        print(f"uvtrace: {tr('error')}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
