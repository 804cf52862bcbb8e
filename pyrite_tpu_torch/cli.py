"""Command-line entry point: ``python -m pyrite_tpu_torch <project.lua>``.

The PyTorch port of pyrite_tpu.cli: the same arguments plus ``--device``
(default ``cuda``; it never moves to the CPU on its own). Loads the Lua
project, renders with periodic preview writes (every >= 20 s, main.rs:
261-299), prints the throughput line and writes the final development to
``<project_dir>/render.png`` or ``--output``.

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


def _not_ported(flag, item):
    raise NotImplementedError(f"{flag} is not ported to pyrite_tpu_torch yet (ROADMAP.md {item})")


def main(argv=None):
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
        help="render across the CUDA devices (not ported yet; on one device it renders as without)",
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
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    # as the JAX package's CLI, --multi-device on one device renders as
    # without it; across several CUDA devices it is not ported
    if args.multi_device and device.type == "cuda" and torch.cuda.device_count() > 1:
        _not_ported("--multi-device", "queue 1 item 11: multi-GPU film merge")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda, but torch finds no CUDA device; pass --device cpu to render on the CPU"
        )

    loading_started = time.time()
    loading_errors = (OSError, LuaError, ProjectError, SyntaxError, ValueError, KeyError)
    try:
        project_data = load_project(args.project)
        scene = build_scene(project_data, device)
    except loading_errors as error:
        print(f"error while loading project file: {error}", file=sys.stderr)
        return 1
    loading_ended = time.time()
    if scene.texture_bytes:
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
        film, acc, wt = algorithm_mod.render(
            project_data, scene, seed=args.seed, on_progress=on_progress, max_samples=args.samples,
            resume=resume,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    rendering_ended = time.time()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, f"render_{os.getpid()}_{int(rendering_started)}.json")
        prof.export_chrome_trace(trace)
        print(f"\nProfiler trace written to {trace}")
    samples = min(settings.pixel_samples, args.samples or settings.pixel_samples)
    lanes = project_data.project.image.width * project_data.project.image.height
    rays = lanes * samples * settings.bounces * (1 + settings.light_samples)
    elapsed = rendering_ended - rendering_started
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
    return 0
