"""Bidirectional path tracing (PyTorch port of
pyrite_tpu.renderers.bidirectional; reference: renderer/bidirectional.rs).

Per pixel sample a camera path and a lamp path are traced; then
(a) the camera path contributes as in the simple renderer,
(b) every diffuse camera vertex connects to every connectable lamp vertex
    through a shadow ray (connect_paths, bidirectional.rs:310-398), and
(c) every diffuse lamp vertex is splatted through the camera lens (light
    tracing, bidirectional.rs:253-306).

As in the JAX package, lamp paths are [N, L + 1] vertex arrays with
validity masks (tracer.trace_lamp_path), the connect_paths suffix walks
collapse to prefix products along the lamp path (``_lamp_path_factors``),
each camera bounce connects to all lamp slots in one flattened [N * K]
shadow batch, and the splats are one flattened [N * K] batch. The step is
the JAX package's one-shot chunk step (``make_render_step``): fused, or in
two phases with the lamp slots compacted to the connectable ones
(``_compact_connections``) when light_bounces + 1 > 16.

On the card every ray goes through a CUDA kernel: the camera bounces
through the bounce kernels' kRecord instantiations and the NEE kernels
(kernels_dense.bounce_dense with record), the lamp bounces through the lamp
kernels (tracer.trace_lamp_path -> kernels_dense.lamp_start /
lamp_bounce), the connection and splat batches through
kernels_dense.shadow_query (dense_shadow_kernel, or wide_shadow_kernel on a
mesh scene, after a march pass on a scene with DE shapes); the rest is
elementwise PyTorch. Random numbers are keyed (rng.py): the camera's as the
simple renderer's, the lamp path's (LAMP_START, LAMP_BOUNCE at each lamp
depth) and the splats' (SPLAT, one block per lamp slot) by the same pixel
and sample, so a render does not depend on its rows per chunk and a resumed
render equals the straight one.

At REGEN_BDPT_MIN_BOUNCES camera bounces or more with path regeneration on,
render takes the camera-regeneration scheduler (``make_regen_launch``, the
JAX package's _render_regen_bdpt): per launch of up to REGEN_BDPT_SPP_CHUNK
samples one lamp round per sample, then one camera walk whose lanes each own
a pixel and regenerate a finished sample in place, sample k of a launch
against round k.

``render_sharded`` renders on one rank of a parallel.mesh: one-shot, a
sample a rank a round; regen, a launch a rank a round (the JAX package's
_render_regen_bdpt_sharded without its splat scales and k_new ladder,
since every rank takes whole launches).

Not ported: the deferred connections and ragged packing, the staged and
merged-traversal camera walks, and the JAX package's TPU switches (its
crash-bisect environment knobs, the splat shadow cap and chunk ladders, the
sweep-kernel block).
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from .. import kernels_dense, tracer
from ..film import Film, bin_lane_sums, expose_lanes, expose_sums
from ..parallel.mesh import device_film_buffers, local_mesh, run_sharded
from ..rng import KeyedDraws, LaneKeys, camera_uniforms, lane_draws, splat_draws
from ..scene import CameraModel, Scene, camera_inverse_project
from ..tracer import DIST_EPSILON, TraceConfig, initial_state, trace_lamp_path
from .simple import (RenderProgress, _accumulate_lane_bins, _HostCount, _uniform_lanes,
                     _uniform_start, camera_rays, camera_wavelengths, chunk_rays, regen_enabled)
from .simple import DE_T_BYTES, lane_bytes as camera_lane_bytes

# Work of the renders since a caller last zeroed them: chunk steps (one-shot),
# lamp traces (one lamp start launch each: a chunk step's, or a regen
# launch's round or batch of rounds), compactions, camera bounce iterations
# (the lamp walk's are tracer.launches["lamp_bounces"]), and the connection
# and splat shadow rays cast, the live rays of each batch (counted on the
# render's device without a host sync: 0-d tensors after a render). The
# regen scheduler's: "regen_bdpt_launches" (launches of up to
# REGEN_BDPT_SPP_CHUNK samples), "regen_bdpt_walks" (camera walks, one per
# chunk of rows and stack of rounds), "regen_bdpt_iterations" (their
# iterations: one draw, bounce and NEE launch and one connection fold each),
# "regen_bdpt_flushes" (walks the stack budget started before a launch's
# last round) and "regen_bdpt_stray_scatters" (iterations that exposed
# connection sums across a lane's pixel edge, make_regen_walk).
counters = {"steps": 0, "lamp_traces": 0, "compactions": 0, "camera_bounces": 0,
            "connection_rays": 0, "splat_rays": 0, "regen_bdpt_launches": 0,
            "regen_bdpt_walks": 0, "regen_bdpt_iterations": 0, "regen_bdpt_flushes": 0,
            "regen_bdpt_stray_scatters": 0}


def _effective_brdf(path):
    """Per-slot brdf: the recorded 2|n.incident| but for a trailing
    limit-ended vertex, which keeps its scattered direction's brdf."""
    brdf = path["brdf"]
    last = torch.where(path["valid"][:, -1], path["brdf_limit"], brdf[:, -1])
    return torch.cat([brdf[:, :-1], last[:, None]], dim=1)


def _slot_colors(scene, color_prog, valid, wavelengths, bank_vals):
    """Each slot's color program at its lane's wavelengths, [N, K, S], on a
    scene whose color programs read no ray: the per-launch program values
    (kernels_dense.precompute_bank_values), or on a scene whose programs
    are baked into a table (scene.bake_bank_tables) that table's values, 0
    where the program is out of range or the slot not valid
    (tracer.eval_color_bank)."""
    n, slots = color_prog.shape
    s = wavelengths.shape[1]
    if scene.color_bank_bakeable is not None:
        return kernels_dense.vertex_colors_plain(scene, color_prog, valid, None, None, None,
                                                 wavelengths)
    cvals = bank_vals[0]  # [Pc, N, S]
    pc = cvals.shape[0]
    if pc == 0:
        return torch.zeros((n, slots, s), device=color_prog.device)
    prog = color_prog.long()
    ok = (prog >= 0) & (prog < pc) & valid
    lane = torch.arange(n, device=prog.device)[:, None]
    vals = cvals.reshape(pc * n, -1)[torch.clamp(prog, 0, pc - 1) * n + lane]
    return torch.where(ok[..., None], vals, 0.0)


def _lamp_path_factors(scene, path, wavelengths, bank_vals):
    """Per-vertex radiance prefix products PP [N, L + 1, S], the
    aux-validity prefix [N, L + 1], the specular flags and the incident
    directions after the reference's pairs() reversal: vertex j sees
    -(the arrival direction of vertex j + 1); the trailing vertex keeps its
    own (bidirectional.rs:187-192)."""
    valid = path["valid"]
    inc = torch.cat([-path["incident_out"][:, 1:], path["incident_out"][:, -1:]], dim=1)
    if any(p.uses_ray_inputs for p in scene.color_programs):
        # read at each vertex's uv, normal and reversed incident direction
        # (pyrite_tpu/renderers/bidirectional.py:73-121): the plain programs
        # on the CPU, program_colors_kernel on a GPU
        color = kernels_dense.vertex_colors(
            scene, path["color_prog"], valid, path["normal"], inc, path["uv"], wavelengths,
            bank_vals)
    else:
        color = _slot_colors(scene, path["color_prog"], valid, wavelengths, bank_vals)
    factor = color * (path["probability"] * _effective_brdf(path))[:, :, None]
    # the emitter slot has brdf 1 already; invalid slots contribute 1
    factor = torch.where(valid[:, :, None], factor, 1.0)
    pp = torch.cumprod(factor, dim=1)
    # a product of 0s and 1s, exact in f32, scanned over dim 1 of [N, K, 1]
    # (PyTorch's CUDA scan of an innermost dim of length K is slow)
    aux_ok = torch.cumprod((~path["dispersed"]).to(torch.float32)[:, :, None], dim=1)[:, :, 0] > 0
    is_specular = valid & ~path["is_diffuse"]
    is_specular[:, 0] = False  # the emitter connects
    return pp, aux_ok, is_specular, inc


def _connection_arrays(scene, path, wavelengths, splat_u, bank_vals):
    """What the camera walk needs of each lamp slot, as one dict at full [N,
    L + 1] capacity: connectable slots (valid and not specular: the emitter
    and the diffuse vertices), splat slots (valid diffuse vertices), the
    prefix products and the splat lens uniforms ``splat_u`` [N, L + 1, 2],
    drawn per original slot index (rng.splat_draws), so that a compacted
    walk draws what the full one does."""
    pp, aux_ok, lamp_specular, _ = _lamp_path_factors(scene, path, wavelengths, bank_vals)
    return {
        "position": path["position"],
        "normal": path["normal"],
        "pp": pp,
        "aux_ok": aux_ok,
        "conn_ok": path["valid"] & ~lamp_specular,
        "splat_ok": path["valid"] & path["is_diffuse"],
        "splat_u": splat_u,
        "length": path["length"],
    }


def connectable_count(conn):
    """The most connectable slots of any lane (a 0-d tensor): the host
    reads it to size the compacted capacity (two-phase step)."""
    return conn["conn_ok"].sum(dim=1).max()


def _compact_connections(conn, k_new: int):
    """The connectable slots of ``conn`` gathered into [N, k_new] arrays,
    in slot order (a sort of each lane's slots on a key that puts the
    connectable ones first): with deep lamp budgets most slots are specular
    or invalid, and every per-bounce connection batch shrinks from N (L + 1)
    to N k_new rays."""
    n, slots = conn["conn_ok"].shape
    idx = torch.arange(slots, device=conn["conn_ok"].device)[None, :]
    order_key = torch.where(conn["conn_ok"], idx, slots + idx)
    order = torch.argsort(order_key, dim=1)[:, :k_new]
    kept = torch.gather(order_key, 1, order) < slots

    def take(x):
        o = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, o.expand((n, k_new) + x.shape[2:]))

    return {
        "position": take(conn["position"]),
        "normal": take(conn["normal"]),
        "pp": take(conn["pp"]),
        "aux_ok": take(conn["aux_ok"]) & kept,
        "conn_ok": take(conn["conn_ok"]) & kept,
        "splat_ok": take(conn["splat_ok"]) & kept,
        "splat_u": take(conn["splat_u"]),
        "length": conn["length"],
    }


def _flat(x):
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _splat_query(camera, conn):
    """The splat batch, every lamp slot flattened to [N K]: (view_xy,
    origin on the lens, unit direction to the vertex, distance, the splats
    that may land: splat slots in front of the camera and inside the
    view)."""
    u = conn["splat_u"]
    view_xy, origin, direction, distance, ok = camera_inverse_project(
        camera, _flat(conn["position"]), _flat(u[..., 0]), _flat(u[..., 1]))
    mask = _flat(conn["splat_ok"]) & ok
    mask &= (torch.abs(view_xy[:, 0]) < 1.0) & (torch.abs(view_xy[:, 1]) < 1.0)
    return view_xy, origin, direction, distance, mask


def _light_splats(scene, film, camera, cfg, conn, wavelengths, acc, wt):
    """Light-tracing splats (bidirectional.rs:253-306): every lamp slot is
    projected and shadow-tested in one flattened [N K] batch
    (kernels_dense.shadow_query over the splats that may land) and exposed
    with one film scatter, at weight 1 / (lamp path length). Updates acc
    and wt in place and returns them."""
    n, slots = conn["conn_ok"].shape
    s_count = wavelengths.shape[1]
    view_xy, origin, direction, distance, mask = _splat_query(camera, conn)
    bound = distance - DIST_EPSILON
    t_hit = kernels_dense.shadow_query(scene, cfg, origin, direction, distance, bound, mask)
    counters["splat_rays"] = counters["splat_rays"] + mask.sum()  # a new tensor: no aliasing
    mask &= ~(torch.isfinite(t_hit) & (t_hit < bound))

    brightness = _flat(conn["pp"]) / torch.clamp(distance * distance, min=1e-20)[:, None]
    cols = tracer._column_mask(_flat(conn["aux_ok"]), s_count)
    splat_weight = 1.0 / torch.clamp(conn["length"], min=1).to(torch.float32)
    weights = splat_weight.repeat_interleave(slots)[:, None].expand(n * slots, s_count)
    wl = wavelengths[:, None, :].expand(n, slots, s_count).reshape(n * slots, s_count)
    return film.expose(acc, wt, view_xy, wl, brightness, weights, mask[:, None] & cols)


def _conn_query(info, conn_position, conn_normal, conn_ok):
    """The connection batch of one camera bounce before occlusion: the
    flattened [N K] shadow rays from each camera vertex to each lamp slot,
    and the geometry terms the fold needs after the verdict. Returns
    (query, pack)."""
    n, slots = conn_ok.shape
    dirvec = conn_position - info["position"][:, None, :]  # [N, K, 3]
    sqd = torch.sum(dirvec * dirvec, dim=-1)
    dist = torch.sqrt(torch.clamp(sqd, min=1e-20))
    conn_dir = dirvec / dist[..., None]
    cos_out_s = torch.sum(info["normal"][:, None, :] * conn_dir, dim=-1)
    cos_in_s = torch.sum(conn_normal * -conn_dir, dim=-1)
    good = info["is_diffuse"][:, None] & conn_ok & (cos_out_s > 0.0) & (cos_in_s > 0.0)
    dist_f = _flat(dist)
    query = {
        "origin": _flat(info["position"][:, None, :].expand(n, slots, 3)),
        "direction": _flat(conn_dir),
        "max_dist": dist_f,
        "block_below": dist_f - DIST_EPSILON,
        "contributes": _flat(good),
    }
    return query, {"good": good, "sqd": sqd, "cos_out_s": cos_out_s, "cos_in_s": cos_in_s}


def _conn_blocked(t_hit, query, n, slots):
    """The occlusion verdict of a flattened connection batch, [N, K]."""
    return (torch.isfinite(t_hit) & (t_hit < query["max_dist"] - DIST_EPSILON)).reshape(n, slots)


def _conn_fold(new_state, info, pack, blocked, pp, aux_ok, conn_vsum, conn_cnt):
    """Connection verdicts folded into the per-lane sums (connect_paths,
    bidirectional.rs:310-398), with new_state's brightness after the
    bounce's NEE, the in-line order. Returns (conn_vsum, conn_cnt) + the
    bounce's sums [N, S]."""
    n, slots = blocked.shape
    s_count = new_state["brightness"].shape[1]
    good = pack["good"] & ~blocked
    brdf_conn = 2.0 * torch.abs(pack["cos_out_s"])
    brdf_ratio = brdf_conn / torch.clamp(info["brdf_stored"][:, None], min=1e-20)
    scale = (torch.abs(pack["cos_in_s"]) * torch.abs(pack["cos_out_s"]) * brdf_ratio
             / (2.0 * math.pi * torch.clamp(pack["sqd"], min=1e-20)))
    delta = new_state["reflectance"][:, None, :] * scale[..., None] * pp
    value = new_state["brightness"][:, None, :] + delta  # [N, K, S]
    aux_take = new_state["aux_alive"][:, None] & aux_ok  # [N, K]
    cols = torch.arange(s_count, device=good.device)[None, None, :]
    take = good[..., None] & ((cols == 0) | aux_take[..., None])
    return (conn_vsum + torch.sum(torch.where(take, value, 0.0), dim=1),
            conn_cnt + torch.sum(take.to(torch.float32), dim=1))


# Bytes the connection step of one camera bounce holds per (lane, lamp
# slot) at S spectral columns: the query (origin, direction, distances,
# flag, t: ~40), the geometry terms (~24) and the fold's [N, K, S]
# temporaries (4 of 4 S). The slots are taken in groups only to bound that
# memory: a group's batch stays within _CONN_GROUP_BYTES, 4 GiB of the 80
# GB card; at the Cornell class (262,144 lanes, S = 10) one group holds 73
# slots, so the 5 of 4 + 4 bounces are one batch.
_CONN_GROUP_BYTES = 4 << 30


def _conn_group_slots(n, s_count):
    return max(1, _CONN_GROUP_BYTES // (max(n, 1) * (64 + 16 * s_count)))


def _connect_fold_grouped(scene, cfg, info, new_state, conn, conn_vsum, conn_cnt):
    """Connection query, occlusion (kernels_dense.shadow_query over the
    rays that contribute) and fold for one camera bounce, over groups of
    lamp slots (_CONN_GROUP_BYTES). Returns the updated sums."""
    n, slots = conn["conn_ok"].shape
    g = _conn_group_slots(n, new_state["brightness"].shape[1])
    for k0 in range(0, slots, g):
        sl = slice(k0, min(k0 + g, slots))
        query, pack = _conn_query(info, conn["position"][:, sl], conn["normal"][:, sl],
                                  conn["conn_ok"][:, sl])
        t_hit = kernels_dense.shadow_query(
            scene, cfg, query["origin"], query["direction"], query["max_dist"],
            query["block_below"], query["contributes"])
        counters["connection_rays"] = counters["connection_rays"] + query["contributes"].sum()
        blocked = _conn_blocked(t_hit, query, n, sl.stop - k0)
        vs, cn = _conn_fold(new_state, info, pack, blocked, conn["pp"][:, sl], conn["aux_ok"][:, sl],
                            torch.zeros_like(conn_vsum), torch.zeros_like(conn_cnt))
        conn_vsum, conn_cnt = conn_vsum + vs, conn_cnt + cn
    return conn_vsum, conn_cnt


def make_render_step(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig,
                     light_bounces: int, rows=None, two_phase: bool = False):
    """The one-shot chunk step over ``rows`` rows of the film (all of them
    by default), for one sample keyed by an rng.KeyedDraws. ``two_phase``
    False: step(acc, wt, draws, row0=0, splat=None) traces the lamp paths
    and the camera walk and exposes them. True: (lamp_step, cam_step):
    lamp_step(draws, row0, wavelengths=None) -> (connection arrays at full
    [N, L + 1] capacity, connectable_count, the chunk's rays and program
    values), which the caller may compact (_compact_connections); with
    ``wavelengths`` [N, S] (camera_wavelengths of the chunk's camera draws)
    it makes no camera rays, and its rays are None; cam_step(acc, wt, draws,
    conn, row0, prepared, splat), where ``prepared`` is lamp_step's third
    output (None to make them again). ``splat`` (acc, wt) takes the light-tracing splats
    in place of acc and wt. Films are updated in place and returned."""
    rows = film.height if rows is None else rows
    lamp_cfg = TraceConfig(bounces=light_bounces, light_samples=0,
                           spectrum_samples=cfg.spectrum_samples, max_de_steps=cfg.max_de_steps)
    dev = scene.device

    def prepare(keyed, row0):
        rays = chunk_rays(film, camera, cfg, keyed, row0=row0, rows=rows, device=dev)
        return rays, kernels_dense.precompute_bank_values(scene, rays[3])

    def lamp_step(draws, row0=0, wavelengths=None):
        keyed = replace(draws, pixel0=row0 * film.width)
        if wavelengths is None:
            rays, bank = prepare(keyed, row0)
            wl = rays[3]
        else:
            rays, wl = None, wavelengths
            bank = kernels_dense.precompute_bank_values(scene, wl)
        path = trace_lamp_path(scene, lamp_cfg, keyed, wl, bank)
        splat_u = splat_draws(keyed, wl.shape[0], light_bounces + 1, dev)
        conn = _connection_arrays(scene, path, wl, splat_u, bank)
        counters["lamp_traces"] += 1
        return conn, connectable_count(conn), (rays, bank)

    def cam_step(acc, wt, draws, conn, row0=0, prepared=None, splat=None):
        keyed = replace(draws, pixel0=row0 * film.width)
        (positions, origin, direction, wl), bank = (
            prepare(keyed, row0) if prepared is None else prepared)
        n, s_count = wl.shape
        state = initial_state(origin, direction, s_count)
        conn_vsum = torch.zeros((n, s_count), device=dev)
        conn_cnt = torch.zeros((n, s_count), device=dev)
        len_cam = torch.zeros(n, dtype=torch.int32, device=dev)
        for i in range(cfg.bounces):
            live = int(state["alive"].sum())
            if live == 0:
                break
            tracer.lane_bounces["live"] += live
            tracer.lane_bounces["executed"] += n
            draws_i = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, i, dev)
            state, info = kernels_dense.bounce_dense(scene, cfg, wl, state, draws_i, bank, record=True)
            counters["camera_bounces"] += 1
            if scene.num_lamps > 0:
                conn_vsum, conn_cnt = _connect_fold_grouped(
                    scene, cfg, info, state, conn, conn_vsum, conn_cnt)
            len_cam += info["recorded"].to(torch.int32)

        # camera-path samples at weight 1 (the hero always, the others while
        # never dispersed), one per pixel of the chunk
        mask = tracer._column_mask(state["aux_alive"], s_count)
        acc, wt = expose_lanes(film, acc, wt, row0, wl, state["brightness"],
                               torch.ones_like(state["brightness"]), mask)
        # connection samples: sums of value x W with weight sums C x W
        w_conn = 1.0 / torch.clamp(len_cam * conn["length"], min=1).to(torch.float32)
        acc, wt = expose_sums(film, acc, wt, positions, wl, conn_vsum * w_conn[:, None],
                              conn_cnt * w_conn[:, None], torch.ones_like(mask))
        sacc, swt = (acc, wt) if splat is None else splat
        _light_splats(scene, film, camera, cfg, conn, wl, sacc, swt)
        counters["steps"] += 1
        return acc, wt

    def chunk_step(acc, wt, draws, row0=0, splat=None):
        conn, _, prepared = lamp_step(draws, row0)
        return cam_step(acc, wt, draws, conn, row0, prepared, splat)

    if two_phase:
        return lamp_step, cam_step
    return chunk_step


# Bytes a chunk step holds per (lane, lamp slot) at S spectral columns:
# the lamp path record (~60), the connection arrays (prefix products 4 S,
# position, normal, flags and splat uniforms ~36) and one camera bounce's
# connection batch and fold (_connect_fold_grouped, 64 + 16 S).
# pick_rows_per_chunk keeps a chunk within _STEP_BYTES, 8 GiB of the 80 GB
# card; the JAX package's lane caps (_LANE_BUDGET, CLUSTER_LANE_CAP) budget
# a TPU's memory and are not carried over.
_STEP_BYTES = 8 << 30


def _slot_bytes(light_bounces: int, spectrum_samples: int) -> int:
    """Bytes a lane's lamp slots take in a chunk step (_STEP_BYTES)."""
    return (light_bounces + 1) * (160 + 20 * spectrum_samples)


def lane_bytes(scene: Scene, cfg: TraceConfig, light_bounces: int) -> int:
    """Bytes a lane's camera walk takes in a chunk step beside its slots:
    simple.lane_bytes, and on a scene with DE shapes the query march pass's
    t of each lamp slot's connection or splat ray (DE_T_BYTES a shape)."""
    slots = light_bounces + 1
    return (camera_lane_bytes(scene, cfg.spectrum_samples, cfg.light_samples)
            + DE_T_BYTES * len(scene.de_shapes) * slots)


def pick_rows_per_chunk(film: Film, light_bounces: int, spectrum_samples: int,
                        texture_bytes: int = 0, lane_bytes: int = 0) -> int:
    """Rows per chunk step: the whole film where its lanes fit _STEP_BYTES
    beside the scene's ``texture_bytes`` (the Cornell class, 512 x 512
    lanes at 4 + 1 slots and S = 10, counts 0.44 GiB), else the largest
    divisor of the height that fits; a lane's camera walk takes
    ``lane_bytes`` beside its slots (simple.lane_bytes)."""
    per_lane = _slot_bytes(light_bounces, spectrum_samples) + lane_bytes
    lanes = max(film.width, max(_STEP_BYTES - texture_bytes, 0) // per_lane)
    rows = max(1, min(film.height, lanes // film.width))
    while film.height % rows:
        rows -= 1
    return rows


# =============================================================================
# Camera-side path regeneration (deep camera budgets)
# =============================================================================
#
# The JAX package's regen BDPT (its bidirectional.py:960-2013), in short:
# with deep camera budgets most camera paths end within a few bounces, so
# the one-shot walk idles most of its lanes. Each lane owns a pixel of a
# chunk of rows and, the moment its sample ends, exposes it into its own row
# of per-lane bins and starts its next sample in place. A sample's
# wavelengths and lamp path belong together, so a launch of ``take`` samples
# first traces one lamp ROUND per sample (round k is sample done + k of
# every pixel of the chunk), exposes each round's light-tracing splats at
# once, compacts it to its connectable slots and stacks the rounds into [n,
# R, K', ...] rows; the camera walk then pairs sample k of a lane with round
# k, swapping the round's row into the lane when it regenerates.
#
# The port keys every draw by (pixel, global sample, bounce, purpose)
# (rng.py): round k is the one-shot lamp step under KeyedDraws(seed, done +
# k), and a regenerated lane draws its camera ray and its bounces with
# LaneKeys(seed, pixel, sample, its own depth). So the regen walk traces
# the paths the one-shot walk traces, scheduled differently, and its film
# equals the one-shot film to summation order. The JAX package instead
# stratifies a launch's wavelengths over its rounds ((r + u) / R) and keys
# by fold_in (ROADMAP.md queue 3, known deviations).

# The JAX package's threshold: the port picks its schedulers as it does.
# Open (ROADMAP.md item 2): on an H100 the regen walk has not beaten the
# one-shot step on any scene measured, the flagship at 16, 64 and 256
# camera bounces included (PERF.md section 5).
REGEN_BDPT_MIN_BOUNCES = 16
REGEN_BDPT_SPP_CHUNK = 32  # samples (= lamp rounds) per launch

# Bytes the stacked rounds of one camera walk may hold, pix x K' x (8 + S) x
# 4 a round (the JAX package's cost formula); past it the stack so far runs
# a walk of its own (a flush). The JAX package's 1 GiB (_CONN_STACK_BUDGET)
# budgets a TPU's memory; the port's is its chunk step budget.
_CONN_STACK_BYTES = _STEP_BYTES

# The fields of a round's connection arrays the camera walk reads per slot
# (the splat fields are spent when the round is traced).
_ROUND_FIELDS = ("position", "normal", "pp", "aux_ok", "conn_ok")


def _accumulate_lane_sums(film: Film, acc_l, wt_l, wavelengths, value_sums, weight_sums):
    """Per-lane (value, weight) sums [N, S] binned into [N, bins] lane
    buffers: the expose_sums analogue of simple._accumulate_lane_bins (the
    JAX package's _accumulate_lane_sums). Returns new buffers."""
    da, dw = bin_lane_sums(film, wavelengths, value_sums, weight_sums)
    return acc_l + da, wt_l + dw


def stack_rounds(conns, wls, light_bounces: int):
    """Pad each round's connection arrays to the widest slot count (to all
    L + 1 slots once that passes 3/4 of them, as the JAX package's
    stack_rounds does) and stack them: ({field: [n, R, K', ...], "length":
    [n, R]}, wavelengths [n, R, S]). Padded slots are inert (conn_ok
    False)."""
    k_max = max(c["conn_ok"].shape[1] for c in conns)
    if k_max > (light_bounces + 1) * 3 // 4:
        k_max = light_bounces + 1

    def pad(x):
        extra = k_max - x.shape[1]
        return x if extra == 0 else torch.cat(
            [x, x.new_zeros((x.shape[0], extra) + x.shape[2:])], dim=1)

    stacked = {f: torch.stack([pad(c[f]) for c in conns], dim=1) for f in _ROUND_FIELDS}
    stacked["length"] = torch.stack([c["length"] for c in conns], dim=1)
    return stacked, torch.stack(wls, dim=1)


def make_regen_walk(scene: Scene, film: Film, camera: CameraModel, cfg: TraceConfig, rows: int,
                    seed: int = 0):
    """The regen BDPT camera walk over a chunk of ``rows`` rows, one lane a
    pixel: walk(acc, wt, conn_r, wl_r, row0, first) completes R samples in
    every lane, samples first .. first + R - 1 of its pixel, sample first +
    k against round k of the stacked rounds (stack_rounds: conn_r [n, R, K',
    ...], wl_r [n, R, S]), and adds them into the film's rows (in place).

    An iteration (the JAX package's cam_step body, in its in-loop form):
    1) expose the samples that ended last iteration: the camera sample into
    the lane's bins (weight 1, the auxiliary columns while never
    dispersed), the connection sums at weight 1 / (len_cam x len_lamp);
    2) regenerate each ended lane that has samples left: its next sample's
    camera ray and the round's row; 3) one bounce of every lane through the
    bounce kernels (kRecord), at each lane's own depth and wavelengths; 4)
    the connections of the bounce's camera vertices to the lane's round;
    5) the depth budget. The host reads the iteration's live count once,
    after the iteration is queued, and ends the walk after an iteration
    with no live lane (which leaves no sample pending). A sample's
    connection sums land where the one-shot renderer exposes them, the
    pixel of its camera position: the lane's own bins, or, where rounding
    puts the position across the pixel's edge (a stray), the film itself
    through expose_sums; that scatter runs only in the iterations after a
    host read that counted a stray sample in flight."""
    w = film.width
    n = rows * w
    s = cfg.spectrum_samples
    dev = scene.device
    lane = torch.arange(n, device=dev)

    def walk(acc, wt, conn_r, wl_r, row0, first):
        rounds = wl_r.shape[1]
        pixel = (row0 * w + lane).to(torch.int32)
        state = initial_state(torch.zeros((n, 3), device=dev), torch.zeros((n, 3), device=dev), s)
        state["alive"] = torch.zeros(n, dtype=torch.bool, device=dev)
        cur = {f: torch.zeros_like(conn_r[f][:, 0]) for f in _ROUND_FIELDS}
        wl = wl_r[:, 0].clone()
        len_lamp = torch.zeros(n, dtype=torch.int32, device=dev)
        positions = torch.zeros((n, 2), device=dev)
        own = torch.zeros(n, dtype=torch.bool, device=dev)
        stray = torch.zeros(n, dtype=torch.bool, device=dev)
        sample = torch.zeros(n, dtype=torch.int32, device=dev)
        done = torch.zeros(n, dtype=torch.int32, device=dev)
        pend = torch.zeros(n, dtype=torch.bool, device=dev)
        plen = torch.zeros(n, dtype=torch.int32, device=dev)
        len_cam = torch.zeros(n, dtype=torch.int32, device=dev)
        conn_vsum = torch.zeros((n, s), device=dev)
        conn_cnt = torch.zeros((n, s), device=dev)
        acc_l = torch.zeros((n, film.bins), device=dev)
        wt_l = torch.zeros((n, film.bins), device=dev)

        # per iteration, read together: the lanes live in it, and the
        # samples in flight that stray (so may end next iteration)
        counts = _HostCount(dev, (2,))
        max_iters = (rounds + 1) * cfg.bounces
        live, i, strays = 0, 0, 0
        while True:
            # 1) expose the samples that ended last iteration
            complete = pend & ~state["alive"]
            _accumulate_lane_bins(film, acc_l, wt_l, wl, state["brightness"], state["aux_alive"],
                                  complete)
            w_conn = torch.where(
                complete, 1.0 / torch.clamp(len_cam * len_lamp, min=1).to(torch.float32), 0.0)
            w_own = torch.where(own, w_conn, 0.0)[:, None]
            acc_l, wt_l = _accumulate_lane_sums(film, acc_l, wt_l, wl, conn_vsum * w_own,
                                                conn_cnt * w_own)
            if strays:
                w_stray = w_conn[:, None]
                expose_sums(film, acc, wt, positions, wl, conn_vsum * w_stray,
                            conn_cnt * w_stray, (complete & stray)[:, None].expand(n, s))
                counters["regen_bdpt_stray_scatters"] += 1
            done = done + complete.to(torch.int32)
            pend = pend & state["alive"]
            # 2) regenerate: the lane's next sample, against its round
            reg = ~state["alive"] & (done < rounds)
            ridx = torch.clamp(done, max=rounds - 1).long()
            for f in _ROUND_FIELDS:
                row = conn_r[f][lane, ridx]
                cur[f] = torch.where(reg.view((n,) + (1,) * (row.dim() - 1)), row, cur[f])
            rc = reg[:, None]
            wl = torch.where(rc, wl_r[lane, ridx], wl)
            len_lamp = torch.where(reg, conn_r["length"][lane, ridx], len_lamp)
            sample = torch.where(reg, first + done, sample)
            plen = torch.where(reg, 0, plen)
            u, draws = lane_draws(LaneKeys(seed, pixel, sample, plen), s, cfg.light_samples,
                                  scene.num_lamps, reg, dev)
            p2, o2, d2, _ = camera_rays(film, camera, s, pixel, u)
            positions = torch.where(rc, p2, positions)
            px, py, on_film = film.view_to_pixel(p2)
            same = py.long() * w + px.long() == pixel
            own = torch.where(reg, on_film & same, own)
            stray = torch.where(reg, on_film & ~same, stray)
            state = {
                "origin": torch.where(rc, o2, state["origin"]),
                "direction": torch.where(rc, d2, state["direction"]),
                "brightness": torch.where(rc, 0.0, state["brightness"]),
                "reflectance": torch.where(rc, 1.0, state["reflectance"]),
                "alive": state["alive"] | reg,
                "aux_alive": state["aux_alive"] | reg,
                "sample_light": state["sample_light"] | reg,
                "light_events": torch.where(reg, 0, state["light_events"]),
            }
            pend = pend | reg
            conn_vsum = torch.where(rc, 0.0, conn_vsum)
            conn_cnt = torch.where(rc, 0.0, conn_cnt)
            len_cam = torch.where(reg, 0, len_cam)
            counts.start(torch.stack([state["alive"].sum(), (pend & stray).sum()]))
            # 3) one bounce of every lane, at its wavelengths' program values
            bank = kernels_dense.precompute_bank_values(scene, wl)
            state, info = kernels_dense.bounce_dense(scene, cfg, wl, state, draws, bank, record=True)
            counters["camera_bounces"] += 1
            # 4) the connections to the lane's round
            if scene.num_lamps > 0:
                conn_vsum, conn_cnt = _connect_fold_grouped(
                    scene, cfg, info, state, cur, conn_vsum, conn_cnt)
            len_cam = len_cam + info["recorded"].to(torch.int32)
            # 5) the per-path depth budget (the one-shot walk's bounce count)
            plen = plen + state["alive"].to(torch.int32)
            state["alive"] = state["alive"] & (plen < cfg.bounces)
            i += 1
            active, strays = counts.read()
            live += active
            if active == 0:
                break
            if i >= max_iters:
                raise RuntimeError(
                    f"regen BDPT walk: {active} lanes still live after {i} iterations, the most "
                    f"{rounds} samples of {cfg.bounces} bounces take")
        short = int((done < rounds).sum())
        if short:
            raise RuntimeError(f"regen BDPT walk: {short} lanes did not complete their {rounds} "
                               f"samples")
        start = row0 * w
        acc.view(film.height * w, film.bins)[start : start + n] += acc_l
        wt.view(film.height * w, film.bins)[start : start + n] += wt_l
        counters["regen_bdpt_walks"] += 1
        counters["regen_bdpt_iterations"] += i
        tracer.lane_bounces["live"] += live
        tracer.lane_bounces["executed"] += i * n
        return acc, wt

    return walk


def _lamp_rounds(lamp_step, film, s, seed, first, take, row0, n, batched, dev):
    """The ``take`` lamp rounds of a launch from sample ``first`` over the
    chunk at ``row0``, each compacted to its connectable slots: yields
    (connection arrays, wavelengths [n, S]) round by round. ``batched``:
    all rounds traced and compacted in one lamp step of n x take lanes (the
    JAX package's lamp_step_all), else one lamp step a round."""

    def compact(conn, count):
        counters["compactions"] += 1
        return _compact_connections(conn, max(int(count), 1))

    def trace(draws):
        # the rounds' wavelengths alone: the walk makes each sample's camera
        # ray when it regenerates
        u = camera_uniforms(replace(draws, pixel0=row0 * film.width), draws.samples * n, s, dev)
        wl = camera_wavelengths(film, s, u)
        conn, count, _ = lamp_step(draws, row0, wavelengths=wl)
        return compact(conn, count), wl

    if batched:
        conn, wl = trace(KeyedDraws(seed, sample0=first, samples=take))
        wl = wl.view(take, n, -1)
        for k in range(take):
            yield {f: v.view((take, n) + v.shape[1:])[k] for f, v in conn.items()}, wl[k]
        return
    for k in range(take):
        yield trace(KeyedDraws(seed, sample0=first + k))


def make_regen_launch(scene, film, camera, cfg, light_bounces, rows, seed):
    """One launch of the regen scheduler (the JAX package's
    _render_regen_bdpt): launch(acc, wt, first, take) renders samples first
    .. first + take - 1 (take <= REGEN_BDPT_SPP_CHUNK) into the film. Per
    chunk of rows the lamp rounds (_lamp_rounds: batched where a chunk's
    rounds fit _STEP_BYTES at full capacity and the lamp budget is at most
    15 bounces, as the JAX package's lamp_step_all), each round's splats in
    a splat film of its own added after it (the one-shot renderer's
    per-sample order; with several chunks a sample's splats are added chunk
    by chunk), the rounds stacked under _CONN_STACK_BYTES, each stack
    walked by make_regen_walk."""
    lamp_step, _ = make_render_step(scene, film, camera, cfg, light_bounces, rows, two_phase=True)
    walk = make_regen_walk(scene, film, camera, cfg, rows, seed)
    n = rows * film.width
    s = cfg.spectrum_samples
    splat = film.new_buffers(scene.device)

    def launch(acc, wt, done, take):
        batched = (light_bounces + 1 <= 16 and n * take * _slot_bytes(light_bounces, s)
                   <= _STEP_BYTES - scene.texture_bytes)
        for row0 in range(0, film.height, rows):
            conns, wls, stacked, first = [], [], 0, done
            for conn, wl in _lamp_rounds(lamp_step, film, s, seed, done, take, row0, n,
                                          batched, scene.device):
                for buf in splat:
                    buf.zero_()
                _light_splats(scene, film, camera, cfg, conn, wl, *splat)
                acc += splat[0]
                wt += splat[1]
                cost = n * conn["conn_ok"].shape[1] * (8 + s) * 4
                if conns and stacked + cost > _CONN_STACK_BYTES:
                    acc, wt = walk(acc, wt, *stack_rounds(conns, wls, light_bounces), row0, first)
                    counters["regen_bdpt_flushes"] += 1
                    first += len(conns)
                    conns, wls, stacked = [], [], 0
                conns.append({f: conn[f] for f in _ROUND_FIELDS + ("length",)})
                wls.append(wl)
                stacked += cost
            acc, wt = walk(acc, wt, *stack_rounds(conns, wls, light_bounces), row0, first)
        counters["regen_bdpt_launches"] += 1
        return acc, wt

    return launch


def make_sample_step(scene, film, camera, cfg, light_bounces, rows, seed):
    """The one-shot scheduler's samples: step(acc, wt, first, count)
    renders samples first .. first + count - 1 one after the other, each
    chunk of rows through the fused step while light_bounces + 1 <= 16,
    else the two-phase step whose host reads each chunk's connectable count
    and compacts the lamp slots to the next power of two (at least 4), so
    that a handful of capacities recur. Each sample's splats are gathered in
    a film of their own and added after its last chunk."""
    slots = light_bounces + 1
    two_phase = slots > 16
    if two_phase:
        lamp_step, cam_step = make_render_step(
            scene, film, camera, cfg, light_bounces, rows, two_phase=True)
    else:
        fused = make_render_step(scene, film, camera, cfg, light_bounces, rows)
    splat = film.new_buffers(scene.device)

    def step(acc, wt, first, count):
        for i in range(first, first + count):
            draws = KeyedDraws(seed, sample0=i, samples=1)
            for buf in splat:
                buf.zero_()
            for row0 in range(0, film.height, rows):
                if two_phase:
                    conn, connectable, prepared = lamp_step(draws, row0)
                    k_new = 4
                    while k_new < int(connectable) and k_new < slots:
                        k_new *= 2
                    conn = _compact_connections(conn, min(k_new, slots))
                    counters["compactions"] += 1
                    acc, wt = cam_step(acc, wt, draws, conn, row0, prepared, splat)
                else:
                    acc, wt = fused(acc, wt, draws, row0, splat)
            acc += splat[0]
            wt += splat[1]
        return acc, wt

    return step


def render(project_data, scene: Scene, seed: int = 0, on_progress=None, max_samples=None,
           resume=None):
    """Render the project with bidirectional path tracing on the scene's
    device; returns (film, acc, wt).

    Dispatch as the JAX package's _render (its bidirectional.py:2072-2151):
    at REGEN_BDPT_MIN_BOUNCES camera bounces or more with path
    regeneration on, the regen scheduler (make_regen_launch, launches of
    up to REGEN_BDPT_SPP_CHUNK samples); else the one-shot samples
    (make_sample_step). ``resume`` (a checkpoint) starts from its film at
    its samples_done; the draws are keyed by the global sample, so the
    resumed render equals the straight one. Each sample's splats are
    gathered in a film of their own and added after its last chunk, so the
    film does not depend on the rows per chunk (pick_rows_per_chunk)."""
    return render_sharded(project_data, scene, local_mesh(scene.device), seed=seed,
                          on_progress=on_progress, max_samples=max_samples, resume=resume)


def render_sharded(project_data, scene: Scene, mesh, seed: int = 0, on_progress=None,
                   max_samples=None, resume=None):
    """render on one rank of ``mesh`` (parallel.mesh), the scene built on
    its device: through run_sharded, one sample a rank a round under the
    one-shot scheduler, one launch of up to REGEN_BDPT_SPP_CHUNK samples a
    rank a round under regen. Every rank returns the merged film; with
    ``on_progress`` the films are merged after every round and rank 0 alone
    reports."""
    project = project_data.project
    settings = project.renderer
    film = Film(width=project.image.width, height=project.image.height,
                bins=settings.spectrum_bins, span=settings.spectrum_span)
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(bounces=settings.bounces, light_samples=settings.light_samples,
                      spectrum_samples=settings.spectrum_samples)
    light_bounces = settings.light_bounces
    rows = pick_rows_per_chunk(film, light_bounces, cfg.spectrum_samples, scene.texture_bytes,
                               lane_bytes=lane_bytes(scene, cfg, light_bounces))
    acc, wt = device_film_buffers(film, mesh, resume)
    start = _uniform_start(resume, film)
    total = settings.pixel_samples if max_samples is None else min(settings.pixel_samples,
                                                                   max_samples)
    if cfg.bounces >= REGEN_BDPT_MIN_BOUNCES and regen_enabled():
        step = make_regen_launch(scene, film, camera, cfg, light_bounces, rows, seed)
        per_rank = REGEN_BDPT_SPP_CHUNK
    else:
        step = make_sample_step(scene, film, camera, cfg, light_bounces, rows, seed)
        per_rank = 1
    progress = None if on_progress is None else (lambda done, a, w: on_progress(RenderProgress(
        sample=done, total=total, acc=a, wt=w, film=film, lane_samples=_uniform_lanes(film, done))))
    return (film, *run_sharded(step, mesh, acc, wt, start, total, per_rank, progress))
