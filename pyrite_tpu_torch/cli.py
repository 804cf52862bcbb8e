"""Command-line entry point: ``python -m pyrite_tpu_torch <project.lua>``.

The PyTorch port of pyrite_tpu.cli: the same arguments plus ``--device``
(default ``cuda``; it never moves to the CPU on its own). Loads the Lua
project, renders with periodic preview writes (every >= 20 s, main.rs:
261-299), prints the throughput line and writes the final development to
``<project_dir>/render.png`` or ``--output``.

``--multi-device`` with more than one CUDA device renders on all of them,
one process (rank) per device over NCCL (``render_rank`` through
parallel.spawn): each rank builds the scene on its own device and traces its
own share of the samples, the films merged by one all-reduce; rank 0 alone
prints and writes. On one device it renders as without the flag.

``--checkpoint PATH`` resumes from PATH if it exists and writes the film
there at every preview: an ``.npz`` with the JAX CLI's keys ``acc``, ``wt``
and ``samples_done`` (so each CLI reads the other's file) and the port's
``lane_samples``, each render lane's count of exposed samples, from which a
resumed render starts every lane at its next sample (renderers.simple
resume_counts); a file without it resumes by the JAX rule, samples_done for
every pixel. ``--profile DIR`` writes a Chrome trace of the render phase
(torch.profiler) into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from .lua.interpreter import LuaError
from .project import load_project
from .project.ir import ProjectError
from .film import save_png
from .scene import build_scene


def make_develop_sample_fn(project_data, scene, span):
    """The image ``filter``/``white`` post-process (main.rs:197-238).

    Returns a callable (values [.., T], wavelengths [T]) -> values, or None.
    """
    from . import spectra as spectra_mod
    from .exprs import NUMBER, ProgramInputs, compile_program

    image = project_data.project.image
    if image.filter is None and image.white is None:
        return None

    resources = scene.resources
    filter_prog = compile_program(image.filter, resources, NUMBER) if image.filter is not None else None
    white_prog = compile_program(image.white, resources, NUMBER) if image.white is not None else None

    white_max = None
    d65_max = None
    if white_prog is not None:
        lo, hi = span
        wl_grid = torch.as_tensor(np.arange(lo, hi, 1.0, np.float32))
        vals = white_prog(ProgramInputs(wavelength=wl_grid)).expand(wl_grid.shape)
        white_max = float(vals.max())
        d65_max = float(spectra_mod.d65().sample(wl_grid).max())

    def sample_fn(values, wavelengths):
        inputs = ProgramInputs(wavelength=wavelengths)
        if filter_prog is not None:
            values = values * filter_prog(inputs).expand(wavelengths.shape)
        if white_prog is not None:
            white_intensity = white_prog(inputs).expand(wavelengths.shape) / white_max
            neutral = values / torch.clamp(white_intensity, min=1e-6)
            values = neutral * (spectra_mod.d65().sample(wavelengths) / d65_max)
        return values

    return sample_fn


_LOADING_ERRORS = (OSError, LuaError, ProjectError, SyntaxError, ValueError, KeyError)


def _parser():
    parser = argparse.ArgumentParser(
        prog="pyrite-tpu-torch", description="spectral path tracer on PyTorch and CUDA"
    )
    parser.add_argument("project", help="path to a .lua project file")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--samples", type=int, default=None, help="override pixel_samples")
    parser.add_argument(
        "--output", default=None, help="output PNG path (default: <project>/render.png)"
    )
    parser.add_argument(
        "--preview-interval", type=float, default=20.0, help="seconds between previews"
    )
    parser.add_argument(
        "--multi-device", action="store_true",
        help="shard samples across all CUDA devices, one process each (NCCL film merge)",
    )
    parser.add_argument(
        "--checkpoint", default=None,
        help="film checkpoint path (.npz): resumed from if present, written at every preview",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the render phase to DIR",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to render on (default cuda; it is never changed on its own)",
    )
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda, but torch finds no CUDA device; pass --device cpu to render on the CPU"
        )
    # as the JAX package's CLI, --multi-device on one device renders as
    # without it
    if args.multi_device and device.type == "cuda" and torch.cuda.device_count() > 1:
        return _render_multi(args, argv)
    return _render(args, device)[0]


def _render_multi(args, argv):
    """--multi-device across the CUDA devices: one rank per device over
    NCCL (parallel.spawn), each running render_rank. The project is loaded
    here first, so that a bad one exits 1 with its message; the scene is
    built by each rank on its own device. A rank that fails raises here."""
    from . import parallel

    try:
        load_project(args.project)
    except _LOADING_ERRORS as error:
        print(f"error while loading project file: {error}", file=sys.stderr)
        return 1
    devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    parallel.spawn(render_rank, devices, "nccl", args=(argv,))
    return 0


def _count_tables():
    from . import kernels, kernels_dense, rng, tracer
    from .parallel import mesh
    from .renderers import bidirectional, photon, simple

    return {"kernels_dense": kernels_dense.launches, "kernels": kernels.launches,
            "tracer": tracer.launches, "rng": rng.launches, "simple": simple.counters,
            "bidirectional": bidirectional.counters, "photon": photon.counters,
            "lane_bounces": tracer.lane_bounces, "merges": mesh.merges}


def render_rank(mesh, argv, attrs=None, env=None):
    """One rank of a --multi-device render (the CLI's arguments ``argv``)
    on ``mesh`` (parallel.mesh): the scene built on the rank's device,
    render_sharded, and on rank 0 alone the progress, previews, checkpoints
    and PNG; --profile writes one trace per rank. ``attrs`` {"module.NAME":
    value} (modules of this package) and ``env`` {variable: value} are set
    for the render and restored after it: a caller picks a scheduler so
    (renderers.simple.POOL_MIN_BOUNCES, PYRITE_TPU_REGEN). Raises when the
    render fails. Returns this rank's launch counts (every count table of
    the package, zeroed before the render), the render's wall seconds (the
    CLI's "Rendering" time, synchronised) and the peak device bytes, and on
    rank 0 the merged film (acc, wt on the CPU)."""
    import importlib

    saved_attrs, saved_env = {}, {}
    try:
        for name, value in (attrs or {}).items():
            module, attr = name.rsplit(".", 1)
            module = importlib.import_module(f"{__package__}.{module}")
            saved_attrs[(module, attr)] = getattr(module, attr)
            setattr(module, attr, value)
        for name, value in (env or {}).items():
            saved_env[name] = os.environ.get(name)
            os.environ[name] = value
        for table in _count_tables().values():
            for k in table:
                table[k] = 0.0 if isinstance(table[k], float) else 0
        cuda = mesh.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(mesh.device)
            torch.cuda.reset_peak_memory_stats(mesh.device)
        rc, acc, wt, seconds = _render(_parser().parse_args(argv), mesh.device, mesh)
        if rc != 0:
            raise RuntimeError(f"rank {mesh.rank}: the render of {argv} returned {rc}")
        result = {"rank": mesh.rank, "seconds": seconds,
                  "peak": torch.cuda.max_memory_allocated(mesh.device) if cuda else None,
                  "counts": {name: {k: (float(v) if isinstance(v, float) else int(v))
                                    for k, v in table.items()}
                             for name, table in _count_tables().items()}}
        if mesh.rank == 0:
            result.update(acc=acc.cpu(), wt=wt.cpu())
        return result
    finally:
        for (module, attr), value in saved_attrs.items():
            setattr(module, attr, value)
        for name, value in saved_env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def render_ranks(mesh, jobs):
    """render_rank for each job of ``jobs`` (dicts of its arguments: argv,
    attrs, env) in turn, in one world; returns their results."""
    return [render_rank(mesh, **job) for job in jobs]


def _render(args, device, mesh=None):
    """The CLI's render on ``device``, alone (``mesh`` None) or as one rank
    of a sharded render. Returns (exit code, acc, wt, the render's wall
    seconds)."""
    lead = mesh is None or mesh.rank == 0
    loading_started = time.time()
    try:
        project_data = load_project(args.project)
        scene = build_scene(project_data, device)
    except _LOADING_ERRORS as error:
        print(f"error while loading project file: {error}", file=sys.stderr)
        return 1, None, None, None
    loading_ended = time.time()
    if scene.texture_bytes and lead:
        print(f"Textures: {len(scene.resources.store)}, {scene.texture_bytes / 2**20:.1f} MiB "
              f"on {device}")

    settings = project_data.project.renderer
    if settings.algorithm == "photon_mapping":
        from .renderers import photon as algorithm_mod
    elif settings.algorithm == "bidirectional":
        from .renderers import bidirectional as algorithm_mod
    else:
        from .renderers import simple as algorithm_mod

    render_path = args.output or os.path.join(
        os.path.dirname(os.path.abspath(args.project)), "render.png"
    )
    sample_fn = make_develop_sample_fn(project_data, scene, settings.spectrum_span)
    state = {"last_preview": time.time()}

    resume = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        with np.load(args.checkpoint) as loaded:
            resume = {k: loaded[k] for k in loaded.files}
        resume["samples_done"] = int(resume["samples_done"])
        if lead:
            print(f"Resuming from {args.checkpoint} ({resume['samples_done']} samples done)")

    def on_progress(progress):
        pct = progress.sample * 100 // progress.total
        print(f"\rRendering: {pct:3d}% ({progress.sample}/{progress.total})", end="")
        now = time.time()
        if now - state["last_preview"] >= args.preview_interval:
            save_png(render_path, progress.film.to_image(progress.acc, progress.wt, 30.0, sample_fn))
            # a preview that holds partial paths (the survivor pool between
            # flushes) is not a checkpoint
            if args.checkpoint and progress.lane_samples is not None:
                np.savez(args.checkpoint, acc=progress.acc.cpu().numpy(), wt=progress.wt.cpu().numpy(),
                         samples_done=progress.sample, lane_samples=progress.lane_samples)
            print(f"  [preview written to {render_path}]")
            state["last_preview"] = now

    rendering_started = time.time()
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profile_ctx = profile(activities=activities)
    with profile_ctx as prof:
        # sharded: every rank passes on_progress (so that all merge), rank
        # 0 alone calls it
        kwargs = dict(seed=args.seed, on_progress=on_progress, max_samples=args.samples,
                      resume=resume)
        if mesh is None:
            film, acc, wt = algorithm_mod.render(project_data, scene, **kwargs)
        else:
            film, acc, wt = algorithm_mod.render_sharded(project_data, scene, mesh, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    rendering_ended = time.time()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        who = f"rank{mesh.rank}_" if mesh is not None else ""
        trace = os.path.join(args.profile,
                             f"render_{who}{os.getpid()}_{int(rendering_started)}.json")
        prof.export_chrome_trace(trace)
        print(f"\nProfiler trace written to {trace}")
    elapsed = rendering_ended - rendering_started
    if not lead:
        return 0, acc, wt, elapsed
    samples = min(settings.pixel_samples, args.samples or settings.pixel_samples)
    lanes = project_data.project.image.width * project_data.project.image.height
    rays = lanes * samples * settings.bounces * (1 + settings.light_samples)
    print(
        f"\nThroughput: {rays / max(elapsed, 1e-9) / 1e6:.1f} Mrays/s "
        f"({samples / max(elapsed, 1e-9):.2f} spp/s), wall {elapsed:.1f}s"
    )

    print("\nSaving final result...")
    save_png(render_path, film.to_image(acc, wt, 2.0, sample_fn))

    print("Done.")
    print(f"Project loading: {loading_ended - loading_started:.2f}s")
    print(f"Rendering: {rendering_ended - rendering_started:.2f}s")
    print(f"Total: {rendering_ended - loading_started:.2f}s")
    print(f"Output: {render_path}")
    return 0, acc, wt, elapsed
