"""The "simple" renderer: camera paths with next-event estimation (PyTorch
port of pyrite_tpu.renderers.simple, one-shot scheduler).

Every step traces one stratified sample for every pixel of the film,
several samples per launch when the film is small, and accumulates into the
film. Sample distribution matches the
reference (uniform jitter per pixel, stratified wavelengths with a
uniformly chosen hero). Random numbers are keyed by the render seed and
(pixel, sample, bounce, purpose) (rng.KeyedDraws), so a seed gives the same
image whatever the samples per launch and the device; tests may give
FixedDraws instead.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..film import Film, expose_lanes
from ..rng import KeyedDraws, camera_uniforms
from ..scene import CameraModel, Scene
from ..tracer import TraceConfig, trace_paths


@dataclass
class FixedDraws:
    """Given random numbers in place of a generator, so a test can feed the
    JAX package and the port the same draws: ``u`` holds one [n, S + 5]
    tensor per sub-sample of a step (chunk_rays), ``bounces`` one draws dict
    per bounce (tracer.trace_paths)."""

    u: list
    bounces: list


def chunk_rays(film: Film, camera: CameraModel, cfg: TraceConfig, rng, row0=0, rows=None,
               device="cuda"):
    """One stratified sample per pixel of a row window and sample:
    positions, primary rays, and hero-ordered wavelengths, in sample order.
    ``rng`` is an rng.KeyedDraws (its samples' camera draws, made on
    ``device``), or the [m, S + 5] uniforms themselves (jitter 2, lens 2,
    wavelengths S, hero 1) of m / (rows x width) samples."""
    h, w = film.height, film.width
    rows = h if rows is None else rows
    n_pix = rows * w
    s = cfg.spectrum_samples
    if isinstance(rng, KeyedDraws):
        keyed = replace(rng, pixel0=row0 * w)
        u = camera_uniforms(keyed, keyed.samples * n_pix, s, device)
    else:
        u = rng
    dev = u.device
    repeat = u.shape[0] // n_pix

    py, px = torch.meshgrid(
        row0 + torch.arange(rows, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    pxf = px.reshape(-1).repeat(repeat) + u[:, 0]
    pyf = py.reshape(-1).repeat(repeat) + u[:, 1]
    positions = film.pixel_to_view(pxf, pyf)
    origin, direction = camera.ray_towards(positions, u[:, 2], u[:, 3])

    wavelengths = film.sample_wavelengths(u[:, 4 : 4 + s])
    # hero selection: swap a uniformly chosen column into slot 0
    hero = torch.clamp((u[:, 4 + s] * s).long(), max=s - 1)
    cols = torch.arange(s, device=dev)[None, :]
    is_hero = cols == hero[:, None]
    hero_wl = torch.gather(wavelengths, 1, hero[:, None])
    first_wl = wavelengths[:, :1]
    wavelengths = torch.where(cols == 0, hero_wl, torch.where(is_hero, first_wl, wavelengths))
    return positions, origin, direction, wavelengths


def pick_sample_batch(film: Film) -> int:
    """Stratified samples per launch, keeping the wavefront under ~600k
    lanes (the JAX package's bound); one launch covers the whole film. The
    JAX package's narrower lane cap for mesh scenes (CLUSTER_LANE_CAP) tunes
    its TPU walk and is not carried over."""
    return max(1, min(4, 600_000 // max(film.height * film.width, 1)))


def make_render_step(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig, rows=None, samples=1):
    """The accumulation step covering ``samples`` stratified samples per
    pixel per launch: step(acc, wt, rng, row0=0) traces them as one
    wavefront and exposes them into the film (in place) in sample order.
    ``rng`` is an rng.KeyedDraws of ``samples`` samples, or FixedDraws."""
    rows = film.height if rows is None else rows

    def step(acc, wt, rng, row0=0):
        if isinstance(rng, FixedDraws):
            u, bounces = torch.cat(rng.u[:samples]), rng.bounces
        else:
            if rng.samples != samples:
                raise ValueError(f"draws for {rng.samples} samples in a step of {samples}")
            u = bounces = replace(rng, pixel0=row0 * film.width)
        _, origin, direction, wavelengths = chunk_rays(
            film, camera, cfg, u, row0=row0, rows=rows, device=scene.device
        )
        brightness, aux_alive = trace_paths(scene, cfg, bounces, origin, direction, wavelengths)
        n, s_count = brightness.shape
        cols = torch.arange(s_count, device=brightness.device)[None, :]
        mask = (cols == 0) | aux_alive[:, None]
        weights = torch.ones_like(brightness)
        per = n // samples
        for s in range(samples):
            sl = slice(s * per, (s + 1) * per)
            acc, wt = expose_lanes(
                film, acc, wt, row0, wavelengths[sl], brightness[sl], weights[sl], mask[sl]
            )
        return acc, wt

    return step


@dataclass
class RenderProgress:
    sample: int
    total: int
    acc: object
    wt: object
    film: object


def render(project_data, scene: Scene, seed: int = 0, on_progress=None, max_samples=None):
    """Render the project with the simple algorithm on the scene's device;
    returns (film, acc, wt).

    This is the JAX package's one-shot scheduler (simple.py:949-976). Its
    default schedulers, path regeneration and the survivor pool for deep
    bounce budgets, are not ported yet (ROADMAP.md queue 1); the JAX
    package's test_regen_scheduler_matches_one_shot holds them to this
    one-shot estimator."""
    project = project_data.project
    settings = project.renderer
    film = Film(
        width=project.image.width,
        height=project.image.height,
        bins=settings.spectrum_bins,
        span=settings.spectrum_span,
    )
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(
        bounces=settings.bounces,
        light_samples=settings.light_samples,
        spectrum_samples=settings.spectrum_samples,
    )
    acc, wt = film.new_buffers(scene.device)
    total = settings.pixel_samples if max_samples is None else min(
        settings.pixel_samples, max_samples
    )

    # Every ported scene, dense or mesh, takes the whole film in one launch,
    # so there are no row windows (the JAX package's pick_rows /
    # chunk_order) to schedule.
    batch = pick_sample_batch(film)
    i = 0
    while i < total:
        take = min(batch, total - i)
        draws = KeyedDraws(seed, sample0=i, samples=take)
        acc, wt = make_render_step(scene, film, camera, cfg, samples=take)(acc, wt, draws)
        i += take
        if on_progress is not None:
            on_progress(RenderProgress(sample=i, total=total, acc=acc, wt=wt, film=film))
    return film, acc, wt
