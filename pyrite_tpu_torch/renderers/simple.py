"""The "simple" renderer: camera paths with next-event estimation (PyTorch
port of pyrite_tpu.renderers.simple) and its three schedulers.

``render`` (``render_sharded`` on one rank of a parallel.mesh) picks the
scheduler as the JAX package does (its simple.py: 928-947): path
regeneration (``_render_regen``) for every dense, DE and mesh scene unless
switched off (``regen_enabled``, ``regen_clusters_enabled``); with it off,
the survivor pool (``_render_pooled``) at POOL_MIN_BOUNCES bounces or more;
else the one-shot wavefront (``make_render_step``), which traces one
stratified sample for every pixel of the film per step, several samples per
launch when the film is small.

Sample distribution matches the reference (uniform jitter per pixel,
stratified wavelengths with a uniformly chosen hero). Random numbers are
keyed by the render seed and (pixel, sample, bounce, purpose) (rng.py): a
path draws the same numbers whichever scheduler traces it, in whichever
lane and wavefront, so the three schedulers trace the same paths and their
films agree up to float summation order (wt, sums of ones, exactly). Tests
may give FixedDraws to the one-shot step instead.

Every scheduler covers the whole film in each launch: the JAX package's
row windows (pick_rows, chunk_order) budget a TPU's memory and watchdog,
and no ported scene needs them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import kernels_dense, tracer
from ..parallel.mesh import (any_left, device_film_buffers, device_sum, local_mesh, merge_films,
                             rank_samples, run_sharded)
from ..film import Film, add_lane_bins, expose_lanes, expose_pixels
from ..rng import KeyedDraws, LaneKeys, bounce_draws, camera_uniforms, lane_draws
from ..scene import CameraModel, Scene
from ..tracer import TraceConfig, initial_state, trace_paths

# Launches of the regeneration and pool schedulers since a caller last
# zeroed them: "regen_launches" (make_regen_step calls) and
# "regen_iterations" (their bounce iterations: one draw, bounce and NEE
# launch each), "pool_stages" and "pool_flushes".
counters = {"regen_launches": 0, "regen_iterations": 0, "pool_stages": 0, "pool_flushes": 0}


@dataclass
class FixedDraws:
    """Given random numbers in place of a generator, so a test can feed the
    JAX package and the port the same draws: ``u`` holds one [n, S + 5]
    tensor per sub-sample of a step (chunk_rays), ``bounces`` one draws dict
    per bounce (tracer.trace_paths)."""

    u: list
    bounces: list


def camera_rays(film: Film, camera: CameraModel, s, pixel, u):
    """Stratified samples of lanes at flat pixel indices ``pixel`` [n] from
    their camera draws ``u`` [n, S + 5] (jitter 2, lens 2, wavelengths S,
    hero 1): positions, primary rays, and hero-ordered wavelengths. Every
    operation is per lane, so a lane's ray does not depend on the others."""
    pixel = pixel.long()
    positions = film.pixel_to_view(pixel % film.width + u[:, 0], pixel // film.width + u[:, 1])
    origin, direction = camera.ray_towards(positions, u[:, 2], u[:, 3])
    return positions, origin, direction, camera_wavelengths(film, s, u)


def camera_wavelengths(film: Film, s, u):
    """camera_rays' hero-ordered wavelengths [n, S] alone, from the camera
    draws ``u`` [n, S + 5]."""
    wavelengths = film.sample_wavelengths(u[:, 4 : 4 + s])
    # hero selection: swap a uniformly chosen column into slot 0
    hero = torch.clamp((u[:, 4 + s] * s).long(), max=s - 1)
    cols = torch.arange(s, device=u.device)[None, :]
    is_hero = cols == hero[:, None]
    hero_wl = torch.gather(wavelengths, 1, hero[:, None])
    first_wl = wavelengths[:, :1]
    return torch.where(cols == 0, hero_wl, torch.where(is_hero, first_wl, wavelengths))


def chunk_rays(film: Film, camera: CameraModel, cfg: TraceConfig, rng, row0=0, rows=None,
               device="cuda"):
    """One stratified sample per pixel of a row window and sample:
    positions, primary rays, and hero-ordered wavelengths, in sample order.
    ``rng`` is an rng.KeyedDraws (its samples' camera draws, made on
    ``device``), or the [m, S + 5] uniforms themselves of m / (rows x width)
    samples."""
    h, w = film.height, film.width
    rows = h if rows is None else rows
    n_pix = rows * w
    s = cfg.spectrum_samples
    if isinstance(rng, KeyedDraws):
        keyed = replace(rng, pixel0=row0 * w)
        u = camera_uniforms(keyed, keyed.samples * n_pix, s, device)
    else:
        u = rng
    pixel = (row0 * w + torch.arange(n_pix, device=u.device)).repeat(u.shape[0] // n_pix)
    return camera_rays(film, camera, s, pixel, u)


# Device memory a wavefront may take beside the scene's textures: 8 GiB of
# the 80 GB card, as bidirectional._STEP_BYTES. A lane takes LANE_BYTES: the
# most that chip_smoke.py's renders measured, a render's peak memory over
# the memory held before it, per lane of its wavefront (phase 5's
# "[memory]" lines on an NVIDIA H100 80GB HBM3: 1,915.5 B under
# regeneration on fractal.lua at S = 8, 1,816.2 B on the textures scene at
# S = 6, 905.8 B there one-shot), rounded up. Past S = 8 a lane takes
# COLUMN_BYTES more for each spectral column (its [N, S] state, wavelengths,
# draws and film bins), and a scene's per-launch program bank BANK_BYTES a
# value: the values, their stacked copy and a temporary (lane_bytes; the
# "[memory]" lines on an NVIDIA H100 80GB HBM3: 5,305.7 B at S = 32 and
# 9,021.7 B at S = 64 on the flagship, 65,733.6 B on 300 materials with
# their 581 colour programs as a per-launch bank at S = 10). On a scene
# with DE shapes the march passes' t rows take DE_T_BYTES a shape for each
# bounce ray and each of its shadow rays (kernels_dense.march_pass's [n_de,
# N] and shadow_pass's [n_de, light samples, N], f32), which LANE_BYTES,
# measured on one shape, does not grow with.
WAVEFRONT_BYTES = 8 << 30
LANE_BYTES = 2048
COLUMN_BYTES = 96
BANK_BYTES = 12
DE_T_BYTES = 4


def lane_bytes(scene: Scene, spectrum_samples: int, light_samples: int) -> int:
    """Bytes a lane of ``scene``'s wavefront takes at S spectral columns and
    ``light_samples`` shadow rays a bounce: LANE_BYTES, COLUMN_BYTES for
    each column past 8, BANK_BYTES for each value of the launch's program
    bank (kernels_dense.precompute_bank_values): S values a lane for each
    color program not baked into a table, for the sky and each directional
    lamp and for each leaf float of the kProg programs, one for each
    probability program not baked; and DE_T_BYTES for each DE shape and
    each of the lane's bounce and shadow rays (the march passes' t)."""
    s = spectrum_samples
    color = 0 if scene.color_bank_bakeable is not None else len(scene.color_programs)
    prob = 0 if scene.prob_bank_bakeable is not None else len(scene.prob_programs)
    pack = scene.dense_pack
    leaves = sum(w for _, w in pack["programs"].leaves) if pack and pack["prog"] else 0
    rows = color + 1 + len(scene.directional_lamps) + leaves
    marched = DE_T_BYTES * len(scene.de_shapes) * (1 + light_samples)
    return LANE_BYTES + COLUMN_BYTES * max(s - 8, 0) + BANK_BYTES * (s * rows + prob) + marched


def lane_budget(texture_bytes: int = 0, lane_bytes: int = LANE_BYTES) -> int:
    """Lanes a wavefront may hold beside ``texture_bytes`` of textures, at
    ``lane_bytes`` a lane."""
    return max(WAVEFRONT_BYTES - texture_bytes, 0) // lane_bytes


def pick_sample_batch(film: Film, texture_bytes: int = 0, lane_bytes: int = LANE_BYTES) -> int:
    """Stratified samples per launch, keeping the wavefront under ~600k
    lanes (the JAX package's bound) and within lane_budget(texture_bytes,
    lane_bytes); one launch covers the whole film. The JAX package's
    narrower lane cap for mesh scenes (CLUSTER_LANE_CAP) tunes its TPU walk
    and is not carried over."""
    pix = max(film.height * film.width, 1)
    return max(1, min(4, 600_000 // pix, lane_budget(texture_bytes, lane_bytes) // pix))


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
        n = brightness.shape[0]
        mask = tracer._column_mask(aux_alive, brightness.shape[1])
        weights = torch.ones_like(brightness)
        per = n // samples
        for s in range(samples):
            sl = slice(s * per, (s + 1) * per)
            acc, wt = expose_lanes(
                film, acc, wt, row0, wavelengths[sl], brightness[sl], weights[sl], mask[sl]
            )
        return acc, wt

    return step


def _run_bounces(scene, cfg, wavelengths, state, keys, depth0, steps):
    """Up to ``steps`` bounces from path depth ``depth0``, with whole-batch
    early exit: the JAX package's _run_bounces. Bounce i draws at bounce
    depth0 + i with ``keys`` (rng.KeyedDraws or LaneKeys). One host read per
    bounce, the alive count, which also counts the live lane-bounces."""
    n = wavelengths.shape[0]
    bank_vals = kernels_dense.precompute_bank_values(scene, wavelengths)
    for i in range(steps):
        live = int(state["alive"].sum())
        if live == 0:
            break
        tracer.lane_bounces["live"] += live
        tracer.lane_bounces["executed"] += n
        draws = bounce_draws(keys, n, depth0 + i, cfg.light_samples, scene.num_lamps, wavelengths.device)
        state = kernels_dense.bounce_dense(scene, cfg, wavelengths, state, draws, bank_vals)
        tracer.launches["bounces"] += 1
    return state


# =============================================================================
# Path-regeneration scheduler (every scene kind, any bounce depth)
# =============================================================================
#
# The JAX package's module comment, in short: the flat wavefront idles most
# of its lanes on shallow scenes (a lane whose path died waits for the
# deepest path of its wavefront), so every lane owns a fixed film pixel and,
# the moment its path dies, exposes the finished sample into its own row of
# per-lane bins and restarts a fresh stratified sample at the same pixel.
# Lanes restart unconditionally while a launch runs ("overshoot": a lane
# past its quota traces extras instead of idling, since the launch lasts
# until its slowest lane anyway), and the quota is enforced at exposure: a
# completed path is included iff the lane's completion count is still
# within its quota. Within a lane paths complete in start order, so the
# inclusion is exactly "the first Q paths": deterministic, hence unbiased.
#
# Sample indices (the port's, with keyed draws). ``planes`` lanes share a
# pixel; plane k of pixel p owns the pixel's samples k, k + planes, k + 2
# planes, ... and lane (k, p)'s count e of exposed samples says which it
# traces next: its m-th path of a launch is sample k + (e + m) planes, drawn
# with that key and its own path depth as the bounce. So a lane's path is
# the one the one-shot wavefront traces for that (pixel, sample), and the
# first-Q rule exposes exactly samples 0 .. total - 1 of every pixel: the
# film does not depend on the quotas, the soft tail, the ramp or the
# iteration at which a launch exits. An extra path a launch drops is traced
# again, identically, by the next launch. A checkpoint keeps each lane's e
# (render's resume), so a resumed render draws no key twice. A sharded
# render's ranks hold interleaved planes of one virtual wavefront
# (_render_regen), so ``planes`` above reads as all the ranks' planes.

REGEN_TARGET_LANES = int(os.environ.get("PYRITE_TPU_REGEN_LANES", "524288"))
REGEN_MAX_PLANES = 8


def regen_enabled() -> bool:
    return os.environ.get("PYRITE_TPU_REGEN", "1") == "1"


def regen_clusters_enabled() -> bool:
    """Regen for mesh (wide-BVH) scenes, on by default as in the JAX
    package."""
    return os.environ.get("PYRITE_TPU_REGEN_CLUSTERS", "1") == "1"


def _accumulate_lane_bins(film: Film, acc_l, wt_l, wavelengths, brightness, aux_alive, complete):
    """Per-lane spectral-bin accumulation, in place, of the paths that
    ``complete`` marks: the hero column always, the others where the path
    kept its auxiliary wavelengths (as the one-shot exposure masks them)."""
    mask = complete[:, None] & tracer._column_mask(aux_alive, brightness.shape[1])
    return add_lane_bins(film, acc_l, wt_l, wavelengths, torch.where(mask, brightness, 0.0),
                         mask.to(brightness.dtype))


class _HostCount:
    """A count on the device (or ``size`` counts) read back to the host
    without waiting for the work queued after it: on a CUDA device the copy
    goes to pinned memory behind an event, so the host can queue the next
    launches first."""

    def __init__(self, device, size=()):
        self.cuda = device.type == "cuda"
        self.host = torch.empty(size, dtype=torch.int64, pin_memory=self.cuda)
        self.event = torch.cuda.Event() if self.cuda else None

    def start(self, count):
        self.host.copy_(count, non_blocking=self.cuda)
        if self.cuda:
            self.event.record()

    def read(self):
        if self.cuda:
            self.event.synchronize()
        return int(self.host) if self.host.dim() == 0 else self.host.tolist()


def make_regen_step(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig, planes=1, seed=0,
                    ranks=1, rank=0):
    """The path-regeneration launch over the whole film, ``planes`` lanes
    per pixel (lane l is pixel l % pixels, plane l // pixels; on rank
    ``rank`` of ``ranks`` of a sharded render, whose lanes are planes of one
    virtual wavefront of ranks x planes, plane j is global plane rank + j x
    ranks).

    step(acc, wt, exposed, spp_lane, tail_count=0) traces until at most
    ``tail_count`` lanes are short of their quota ``spp_lane`` [n], exposes
    at most spp_lane[l] paths of lane l, the first ones it completes, into
    the film (in place), and returns (acc, wt, live lane-bounces, executed
    lane-bounces, done [n] int32: every completion, discarded extras
    included). ``exposed`` [n] is each lane's count of samples exposed
    before the launch, which sets the sample indices its paths stand for
    (module comment). The host keeps the remainders: the caller subtracts
    min(done, quota) from them. An iteration is one draw launch (the
    regenerated lanes' camera draws and every lane's bounce draws at its
    own depth), the scene's bounce kernels (bounce and NEE, after the march
    passes on a DE scene) and the exposure's small launches; the host reads
    the short-lane count once an iteration, after queuing the bounce."""
    pix = film.height * film.width
    n = pix * planes
    planes_total = ranks * planes
    s = cfg.spectrum_samples
    dev = scene.device
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    pixel, plane = lane % pix, rank + (lane // pix) * ranks

    def step(acc, wt, exposed, spp_lane, tail_count=0):
        spp_h = np.asarray(spp_lane)
        first = torch.as_tensor(np.asarray(exposed, np.int32), device=dev)
        spp = torch.as_tensor(spp_h.astype(np.int32), device=dev)
        state = initial_state(torch.zeros((n, 3), device=dev), torch.zeros((n, 3), device=dev), s)
        state["alive"] = torch.zeros(n, dtype=torch.bool, device=dev)
        wl = torch.full((n, s), film.span[0], device=dev)
        acc_l = torch.zeros((n, film.bins), device=dev)
        wt_l = torch.zeros((n, film.bins), device=dev)
        done = torch.zeros(n, dtype=torch.int32, device=dev)
        pend = torch.zeros(n, dtype=torch.bool, device=dev)
        plen = torch.zeros(n, dtype=torch.int32, device=dev)
        sample = torch.zeros(n, dtype=torch.int32, device=dev)
        short_n, live, i = int((spp_h > 0).sum()), 0, 0
        max_iters = (int(spp_h.max(initial=0)) + 1) * cfg.bounces
        short_count = _HostCount(dev)
        while short_n > tail_count and i < max_iters:
            # 1) expose the paths that completed last bounce, the lane's
            # first Q only (done counts every completion)
            complete = pend & ~state["alive"]
            done = done + complete.to(torch.int32)
            _accumulate_lane_bins(film, acc_l, wt_l, wl, state["brightness"], state["aux_alive"],
                                  complete & (done <= spp))
            pend = pend & state["alive"]
            # 2) regenerate every dead lane, even past its quota: its next
            # sample at its pixel, with that sample's key
            reg = ~state["alive"]
            sample = torch.where(reg, plane + (first + done) * planes_total, sample)
            plen = torch.where(reg, 0, plen)
            u, draws = lane_draws(LaneKeys(seed, pixel, sample, plen), s, cfg.light_samples,
                                  scene.num_lamps, reg, dev)
            _, o2, d2, wl2 = camera_rays(film, camera, s, pixel, u)
            rc = reg[:, None]
            state = {
                "origin": torch.where(rc, o2, state["origin"]),
                "direction": torch.where(rc, d2, state["direction"]),
                "brightness": torch.where(rc, 0.0, state["brightness"]),
                "reflectance": torch.where(rc, 1.0, state["reflectance"]),
                "alive": torch.ones(n, dtype=torch.bool, device=dev),
                "aux_alive": state["aux_alive"] | reg,
                "sample_light": state["sample_light"] | reg,
                "light_events": torch.where(reg, 0, state["light_events"]),
            }
            wl = torch.where(rc, wl2, wl)
            pend = pend | reg
            # live counts the quota-bound lanes (a lane's in-flight path
            # exposes iff done < Q); the same count ends the launch
            short_count.start((done < spp).sum())
            # 3) one bounce for every lane
            bank_vals = kernels_dense.precompute_bank_values(scene, wl)
            state = kernels_dense.bounce_dense(scene, cfg, wl, state, draws, bank_vals)
            tracer.launches["bounces"] += 1
            # 4) the per-path depth budget
            plen = plen + state["alive"].to(torch.int32)
            state["alive"] = state["alive"] & (plen < cfg.bounces)
            short_n = short_count.read()
            live += short_n
            i += 1
        # the last iteration's deaths; paths still in flight are dropped
        # (past-quota extras, or a short lane's next sample, which its next
        # launch traces again)
        complete = pend & ~state["alive"]
        _accumulate_lane_bins(film, acc_l, wt_l, wl, state["brightness"], state["aux_alive"],
                              complete & (done < spp))
        acc.view(pix, film.bins).add_(acc_l.view(planes, pix, film.bins).sum(dim=0))
        wt.view(pix, film.bins).add_(wt_l.view(planes, pix, film.bins).sum(dim=0))
        counters["regen_launches"] += 1
        counters["regen_iterations"] += i
        tracer.lane_bounces["live"] += live
        tracer.lane_bounces["executed"] += i * n
        # the completion counts include the post-loop exposure's: the host
        # subtracts min(done, quota) from its remainders
        return acc, wt, live, i * n, done + complete.to(torch.int32)

    return step


def _regen_planes(film: Film, texture_bytes: int = 0, lane_bytes: int = LANE_BYTES) -> int:
    """Lanes per pixel: REGEN_TARGET_LANES over the film, within
    lane_budget(texture_bytes, lane_bytes), 1 to REGEN_MAX_PLANES. The JAX package's
    narrower targets for mesh scenes (CLUSTER_LANE_CAP, a TPU walk tuning)
    and texture scenes (texture_lane_cap, a TPU worker's footprint) are
    left out."""
    pix = max(film.height * film.width, 1)
    return max(1, min(REGEN_MAX_PLANES, REGEN_TARGET_LANES // pix,
                      lane_budget(texture_bytes, lane_bytes) // pix))


def adaptive_quotas(rem, rate, spp_target):
    """Per-launch lane quotas balanced by measured completion rates (the
    JAX package's, exactly): a launch runs until its slowest lane completes
    its quota, so a lane gets quota ~ rate x T and all lanes finish near
    the same iteration T. Quotas are clipped to the per-lane remaining
    counts ``rem``, and a lane with work gets at least 1.

    ``rate`` completions/lane/iteration (None before the first launch ->
    uniform quotas); ``spp_target`` samples the mean lane should complete."""
    if rate is None:
        return np.minimum(rem, spp_target).astype(np.int32)
    t = spp_target / max(float(rate.mean()), 1e-6)
    q = np.rint(rate * t).astype(np.int32)
    return np.minimum(rem, np.maximum(q, 1)).astype(np.int32)


def _render_regen(scene, film, camera, cfg, acc, wt, seed, resume, total, on_progress,
                  spp_chunk=None, planes=None, mesh=None):
    """Host driver of the regeneration scheduler: launches until every lane
    has exposed its samples, each lane starting after the samples a
    checkpoint ``resume`` already holds (resume_counts). Quotas are
    balanced per lane by measured completion rates (adaptive_quotas) and
    each launch exits once <= 1 % of lanes are short of quota (the soft
    tail: the remainders carry into the next launch's quotas); the quota
    ramps up to ``spp_chunk`` over the first launches so that the rates warm
    and a preview lands early.

    On a ``mesh`` of D ranks (None: this process alone) the ranks' planes
    are planes of one virtual wavefront of D x planes: rank r owns planes r,
    r + D, r + 2 D, ..., so the ranks trace disjoint samples of every pixel
    and share a pixel's samples within one. Their launch counts differ, so
    they loop in step on the host flag (any_left), a rank with nothing left
    launching nothing. A progress report's ``lane_samples`` holds all D x
    planes planes, summed over the ranks on their devices."""
    mesh = local_mesh(scene.device) if mesh is None else mesh
    if planes is None:
        planes = _regen_planes(film, scene.texture_bytes,
                               lane_bytes=lane_bytes(scene, cfg.spectrum_samples, cfg.light_samples))
    pix = film.height * film.width
    n = pix * planes
    d, r = mesh.size, mesh.rank
    planes_total = d * planes
    step = make_regen_step(scene, film, camera, cfg, planes=planes, seed=seed, ranks=d, rank=r)
    if spp_chunk is None:
        spp_chunk = 64 if (scene.use_clusters or cfg.bounces >= POOL_MIN_BOUNCES) else 160
    k = np.repeat(r + d * np.arange(planes), pix)
    exposed = resume_counts(resume, planes_total, film).reshape(planes_total, pix)[r::d].flatten()
    rem = np.maximum((total - k + planes_total - 1) // planes_total - exposed, 0)
    rate = None
    cur_chunk = max(4, spp_chunk // 8)
    while any_left(rem.any(), mesh):
        if rem.any():
            quota = adaptive_quotas(rem, rate, cur_chunk)
            # soft tail: up to 1 % of lanes may stay short, but the launch
            # must complete at least one quota-bound lane so that the loop
            # progresses
            active = int((quota > 0).sum())
            tail = min(n // 100, active - 1) if active > 1 else 0
            acc, wt, _, ex, dn = step(acc, wt, exposed, quota, tail)
            dn_h = dn.cpu().numpy()
            took = np.minimum(dn_h, quota)
            exposed += took
            rem -= took
            # completion rate, discarded extras included (they complete at
            # the lane's own pace); the iteration count follows from the
            # keyed draws, so the quotas, and the render, repeat for a seed
            iters = max(float(ex) / n, 1.0)
            fresh = np.maximum(dn_h.astype(np.float32), 0.25) / iters
            rate = fresh if rate is None else 0.5 * (rate + fresh)
            cur_chunk = min(spp_chunk, cur_chunk * 2)
        if on_progress is not None:
            p_acc, p_wt = merge_films(acc, wt, mesh)
            if d == 1:
                lanes = exposed.copy()
            else:
                # the lane counts ride the films' group: through the host
                # they took longer than the launches on four cards
                lanes = torch.zeros((planes_total, pix), dtype=torch.int64, device=mesh.device)
                lanes[r::d] = torch.from_numpy(exposed.reshape(planes, pix)).to(mesh.device)
                lanes = device_sum(lanes, mesh).cpu().numpy()
            if mesh.rank == 0:
                on_progress(RenderProgress(
                    sample=min(total, int(lanes.reshape(planes_total, pix).sum(axis=0).min())),
                    total=total, acc=p_acc, wt=p_wt, film=film,
                    lane_samples=lanes.reshape(planes_total, film.height, film.width),
                ))
    return (film, *merge_films(acc, wt, mesh))


# =============================================================================
# Survivor-pool scheduler (deep bounce budgets with regeneration off)
# =============================================================================
#
# For deep path budgets the flat wavefront is almost empty almost at once.
# Each sample traces a short stage of STAGE_BOUNCES over the whole film;
# lanes that died are exposed, survivors are compacted into a pool
# (POOL_FACTOR x the film's lanes) that continues tracing only when full,
# down a shrinking width ladder. Every lane is exposed exactly once. A pool
# lane carries its pixel and sample, so its later bounces draw with its own
# keys; all pool lanes share one depth (STAGE_BOUNCES + the flush bounces so
# far), as in the JAX package, whose host sizes the flush launches by it.

POOL_MIN_BOUNCES = 16  # below this, the flat wavefront is fine
STAGE_BOUNCES = 8  # bounces traced before survivors are pooled
CONT_BOUNCES = 32  # bounces per pool-continuation launch
POOL_FACTOR = 8  # pool capacity as a multiple of the stage's lanes

_STATE = ("origin", "direction", "brightness", "reflectance", "alive", "aux_alive",
          "sample_light", "light_events")


def _full_mask(state):
    return tracer._column_mask(state["aux_alive"], state["brightness"].shape[1])


def make_pooled_steps(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig, seed=0):
    """The pieces of the survivor-pool scheduler: (stage, empty_pool,
    flush_step, shrink, expose_pool). A pool is a dict of the lane state,
    ``wavelengths``, ``pixel`` and ``sample`` (int32) and ``valid``. A pool
    exposes by the pixel its lanes carry (film.expose_pixels), which is the
    pixel Film.expose finds from the lane's jittered view position save
    where rounding puts that position across the pixel's edge (see
    tests/test_torch_schedulers.py): the carried index is the one-shot
    wavefront's, so the pool's film equals it."""
    n = film.height * film.width
    s = cfg.spectrum_samples
    dev = scene.device
    pool_n = POOL_FACTOR * n
    pixels = torch.arange(n, dtype=torch.int32, device=dev)

    def empty_pool(width=pool_n):
        state = initial_state(torch.zeros((width, 3), device=dev), torch.ones((width, 3), device=dev), s)
        state["alive"] = torch.zeros(width, dtype=torch.bool, device=dev)
        return dict(
            state, wavelengths=torch.full((width, s), film.span[0], device=dev),
            pixel=torch.zeros(width, dtype=torch.int32, device=dev),
            sample=torch.zeros(width, dtype=torch.int32, device=dev),
            valid=torch.zeros(width, dtype=torch.bool, device=dev),
        )

    def stage(acc, wt, pool, fill, sample):
        """Sample ``sample`` of every pixel: trace STAGE_BOUNCES, expose the
        lanes that completed, and compact the survivors into the pool at
        offset ``fill``. Returns (acc, wt, pool, survivors)."""
        keyed = KeyedDraws(seed, sample0=sample)
        u = camera_uniforms(keyed, n, s, dev)
        _, origin, direction, wavelengths = camera_rays(film, camera, s, pixels, u)
        state = _run_bounces(scene, cfg, wavelengths, initial_state(origin, direction, s), keyed, 0,
                             STAGE_BOUNCES)
        alive = state["alive"]
        acc, wt = expose_lanes(film, acc, wt, 0, wavelengths, state["brightness"],
                               torch.ones_like(state["brightness"]), _full_mask(state) & ~alive[:, None])
        idx = alive.nonzero().squeeze(1)
        at = slice(fill, fill + idx.numel())
        for k in _STATE:
            pool[k][at] = state[k][idx]
        pool["wavelengths"][at] = wavelengths[idx]
        pool["pixel"][at] = idx.to(torch.int32)
        pool["sample"][at] = sample
        pool["valid"][at] = True
        counters["pool_stages"] += 1
        return acc, wt, pool, idx.numel()

    def flush_step(pool, depth0, steps):
        """Continue a pool ``steps`` bounces from depth ``depth0``; returns
        (pool, alive count)."""
        keys = LaneKeys(seed, pool["pixel"], pool["sample"])
        state = _run_bounces(scene, cfg, pool["wavelengths"], {k: pool[k] for k in _STATE}, keys,
                             depth0, steps)
        pool.update(state)
        return pool, int(state["alive"].sum())

    def expose(acc, wt, pool, which):
        brightness = pool["brightness"]
        return expose_pixels(film, acc, wt, pool["pixel"], which, pool["wavelengths"], brightness,
                             torch.ones_like(brightness), _full_mask(pool))

    def shrink(acc, wt, pool, width_to):
        """Expose a pool's finished lanes and compact the live ones into a
        ``width_to``-wide pool (the caller shrinks only when they fit): one
        rung of the flush ladder."""
        acc, wt = expose(acc, wt, pool, pool["valid"] & ~pool["alive"])
        idx = (pool["valid"] & pool["alive"]).nonzero().squeeze(1)
        small = empty_pool(width_to)
        for k, v in pool.items():
            small[k][: idx.numel()] = v[idx]
        return acc, wt, small

    def expose_pool(acc, wt, pool):
        return expose(acc, wt, pool, pool["valid"])

    return stage, empty_pool, flush_step, shrink, expose_pool


def _render_pooled(scene, film, camera, cfg, acc, wt, seed, start, total, on_progress, mesh=None):
    """Host loop of the survivor-pool scheduler. The JAX package flushes its
    pool in segments (its simple.py:1004-1017) because XLA materialised
    [lanes, primitives] temporaries at the pool's width; the port's bounce
    kernels keep no such temporary, so the whole pool flushes at once. On a
    ``mesh`` of D ranks each rank stages its share of every D samples
    (rank_samples) into a pool of its own; a report's ``lane_samples`` is
    None while any rank's pool holds lanes."""
    mesh = local_mesh(scene.device) if mesh is None else mesh
    stage, empty_pool, flush_step, shrink, expose_pool = make_pooled_steps(
        scene, film, camera, cfg, seed)
    capacity = film.height * film.width
    # the flush plan caps continuation depth at exactly bounces - STAGE
    q, r = divmod(cfg.bounces - STAGE_BOUNCES, CONT_BOUNCES)
    flush_plan = [CONT_BOUNCES] * q + ([r] if r else [])

    def flush(acc, wt, pool, fill):
        """Run the pool to completion down a shrinking width ladder: after
        each continuation, if the survivors fit a 4x narrower pool, expose
        the finished lanes and compact."""
        if fill == 0:
            return acc, wt, pool
        counters["pool_flushes"] += 1
        depth = STAGE_BOUNCES
        for steps in flush_plan:
            pool, count = flush_step(pool, depth, steps)
            depth += steps
            if count == 0:
                break
            width = pool["valid"].shape[0]
            while width >= 2048 and count <= width // 4:
                acc, wt, pool = shrink(acc, wt, pool, width // 4)
                width //= 4
        acc, wt = expose_pool(acc, wt, pool)
        return acc, wt, empty_pool()

    pool, fill = empty_pool(), 0
    for first, count, done in rank_samples(mesh, start, total):
        for i in range(first, first + count):
            # flush whenever the space left could not take an all-survive
            # stage
            if fill + capacity > POOL_FACTOR * capacity:
                acc, wt, pool = flush(acc, wt, pool, fill)
                fill = 0
            acc, wt, pool, survivors = stage(acc, wt, pool, fill, i)
            fill += survivors
        if on_progress is not None:
            # the preview includes the pooled survivors' partial sums; the
            # film alone holds whole samples only while no pool holds lanes
            p_acc, p_wt = (acc, wt) if fill == 0 else expose_pool(acc.clone(), wt.clone(), pool)
            pooled = any_left(fill > 0, mesh)
            p_acc, p_wt = merge_films(p_acc, p_wt, mesh)
            if mesh.rank == 0:
                on_progress(RenderProgress(
                    sample=done, total=total, acc=p_acc, wt=p_wt, film=film,
                    lane_samples=None if pooled else _uniform_lanes(film, done)))
    acc, wt, pool = flush(acc, wt, pool, fill)
    return (film, *merge_films(acc, wt, mesh))


@dataclass
class RenderProgress:
    """A render's progress: ``sample`` samples of every pixel are in the
    film, ``total`` are asked for. ``lane_samples`` [planes, H, W] counts
    each lane's exposed samples (plane k of a pixel owns its samples k, k +
    planes, ...; one plane but for regeneration) when acc / wt hold exactly
    those samples, so that a checkpoint of them resumes exactly; None when
    acc / wt are a preview that includes partial paths (the survivor pool
    between flushes)."""

    sample: int
    total: int
    acc: object
    wt: object
    film: object
    lane_samples: object = None


def _uniform_lanes(film, samples):
    return np.full((1, film.height, film.width), samples, np.int64)


def _prefix_counts(lanes):
    """Per-pixel sample counts of lane counts ``lanes`` [planes, pixels]
    whose exposed samples are a prefix 0 .. c - 1 of every pixel's; raises
    ValueError otherwise."""
    planes = lanes.shape[0]
    counts = lanes.sum(axis=0)
    k = np.arange(planes)[:, None]
    if not np.array_equal(lanes, (counts[None, :] - k + planes - 1) // planes):
        raise ValueError(
            f"the checkpoint's {planes} lanes per pixel hold samples that are not the first ones of "
            f"each pixel; resume it with the scheduler that wrote it (regeneration, "
            f"{planes} planes)")
    return counts


def resume_counts(resume, planes, film):
    """Each lane's count of exposed samples, [planes x pixels] int64, from a
    checkpoint (None: a fresh render): its ``lane_samples`` where it has
    them (a port checkpoint) and they have this render's planes; else the
    per-pixel counts they add up to, which must be a prefix of each pixel's
    samples; else ``samples_done`` for every pixel (a JAX package
    checkpoint, the JAX rule)."""
    pix = film.height * film.width
    if resume is None:
        return np.zeros(planes * pix, np.int64)
    lanes = resume.get("lane_samples")
    if lanes is not None:
        lanes = np.asarray(lanes, np.int64).reshape(-1, pix)
        if lanes.shape[0] == planes:
            return lanes.reshape(-1)
        counts = _prefix_counts(lanes)
    else:
        counts = np.full(pix, int(resume["samples_done"]), np.int64)
    k = np.arange(planes)[:, None]
    return ((counts[None, :] - k + planes - 1) // planes).reshape(-1)


def _uniform_start(resume, film):
    """The sample every pixel resumes at, for the one-shot and pool
    schedulers, which step all pixels together."""
    counts = resume_counts(resume, 1, film)
    if counts.min() != counts.max():
        raise ValueError(
            "the checkpoint's pixels hold different sample counts; the one-shot and survivor-pool "
            "schedulers resume only a film whose pixels all hold the same count: resume it with "
            "path regeneration (PYRITE_TPU_REGEN=1)")
    return int(counts[0])


def render(project_data, scene: Scene, seed: int = 0, on_progress=None, max_samples=None, resume=None):
    """Render the project with the simple algorithm on the scene's device;
    returns (film, acc, wt).

    Dispatch as the JAX package's render: regeneration for every scene
    while regen_enabled() (mesh scenes also need regen_clusters_enabled());
    else the survivor pool at POOL_MIN_BOUNCES bounces or more; else the
    one-shot wavefront. ``resume`` (a checkpoint: acc, wt, samples_done and,
    from the port's CLI, lane_samples) starts from its film, and every lane
    from the next sample it has not exposed (resume_counts). Every scheduler
    launches the whole film (no row windows), so the JAX package's
    chunk_order is not needed."""
    return render_sharded(project_data, scene, local_mesh(scene.device), seed=seed,
                          on_progress=on_progress, max_samples=max_samples, resume=resume)


def render_sharded(project_data, scene: Scene, mesh, seed: int = 0, on_progress=None,
                   max_samples=None, resume=None):
    """render on one rank of ``mesh`` (parallel.mesh), the scene built on
    its device: the ranks render disjoint samples and every rank returns
    the merged film. Dispatch as render's. One-shot: groups of D x
    pick_sample_batch samples, a contiguous slice of each a rank
    (run_sharded); regeneration: virtual planes (_render_regen); the pool:
    one pool a rank (_render_pooled). With ``on_progress`` the films are
    merged after every round and rank 0 alone reports."""
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
    acc, wt = device_film_buffers(film, mesh, resume)
    total = settings.pixel_samples if max_samples is None else min(
        settings.pixel_samples, max_samples
    )

    if regen_enabled() and (not scene.use_clusters or regen_clusters_enabled()):
        return _render_regen(scene, film, camera, cfg, acc, wt, seed, resume, total, on_progress,
                             mesh=mesh)

    start = _uniform_start(resume, film)
    if cfg.bounces >= POOL_MIN_BOUNCES:
        return _render_pooled(scene, film, camera, cfg, acc, wt, seed, start, total, on_progress,
                              mesh=mesh)

    batch = pick_sample_batch(film, scene.texture_bytes,
                              lane_bytes=lane_bytes(scene, cfg.spectrum_samples, cfg.light_samples))

    def step(acc, wt, first, count):
        draws = KeyedDraws(seed, sample0=first, samples=count)
        return make_render_step(scene, film, camera, cfg, samples=count)(acc, wt, draws)

    progress = None if on_progress is None else (lambda done, a, w: on_progress(RenderProgress(
        sample=done, total=total, acc=a, wt=w, film=film, lane_samples=_uniform_lanes(film, done))))
    return (film, *run_sharded(step, mesh, acc, wt, start, total, batch, progress))
