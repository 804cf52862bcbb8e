"""Progressive photon mapping (PyTorch port of pyrite_tpu.renderers.photon;
reference: renderer/photon_mapping.rs).

Per pixel sample the renderer (1) traces camera paths, recording each
diffuse hit with the prefix product of its chain, (2) shoots photon
batches from the lamps, keeping the diffuse lamp-path vertices with their
accumulated power, and (3) gathers the photons within a fixed radius of
every camera vertex, multiplying the camera-side chain by the photon-side
one (photon_mapping.rs:340-426). The estimator is the JAX package's:

  - a camera vertex carries partialR(lambda), the product over its chain of
    color x probability x brdf times its own color x probability (its brdf,
    2|n.exit|, is applied per gathered photon); a photon carries its power;
  - the kd-tree radius query is a hash grid: photons sorted by cell key
    (cell size = radius), each camera vertex scanning the 27 neighbouring
    cells, at most _CELL_CAP photons a cell;
  - each lamp path carries one uniform wavelength; a gathered pair exposes
    a primary sample at the photon's wavelength (the camera's hero where the
    camera vertex dispersed; none where both dispersed) and, where neither
    dispersed, spectrum_samples fresh wavelengths drawn per (vertex, bounce);
  - chains at other wavelengths are re-walked exactly on scenes whose color
    programs read only the wavelength (exact_chain_mode: color-program
    counts and scalar prefixes, _chain_eval), else interpolated from a
    wavelength grid traced beside the film columns (interp_cols; the grid's
    size is scene.grid_bins'); build_scene decides the mode once, into
    scene.photon_widths, which _build_parts reads.

On the card the camera walk goes through the bounce kernels' kRecord
instantiations (kernels_dense.bounce_dense with record and chain), the
photon walk through the lamp kernels (tracer.trace_lamp_path), and the
gather of each camera bounce through photon_gather_kernel
(kernels_dense.photon_gather, csrc/photon.cu); ``gather_plain`` is its
plain version. The sort and the film exposures are PyTorch.

Draws are keyed (rng.py): sample i's camera pass by global sample i (1 +
P), its photon pass p by i (1 + P) + 1 + p (the photons' wavelengths and
lamp paths by photon index, the fresh wavelengths by pixel), so a resumed
render equals the straight one and the film does not depend on the rows per
chunk. A chunk of camera rows is gathered against every pass's photon map
of the sample, which are built first.

``render_sharded`` renders on one rank of a parallel.mesh, a sample a rank a
round.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from .. import geometry as geom
from .. import kernels_dense, rng, tracer
from ..exprs import ProgramInputs
from ..film import Film, expose_lanes, expose_sums
from ..parallel.mesh import device_film_buffers, local_mesh, run_sharded
from ..rng import KeyedDraws
from ..scene import CameraModel, Scene, exact_chain_mode  # noqa: F401 (the JAX package's name)
from ..tracer import TraceConfig, initial_state, trace_lamp_path
from .bidirectional import _effective_brdf, _lamp_path_factors
from .simple import RenderProgress, _uniform_lanes, _uniform_start, chunk_rays
from .simple import DE_T_BYTES, lane_bytes as camera_lane_bytes

_CELL_CAP = 32  # the most photons a query takes from one grid cell
_HASH = (73856093, 19349663, 83492791)  # the JAX package's cell-key multipliers
_INT32_MAX = 2**31 - 1
# the 27 neighbour-cell offsets a query scans, in the JAX package's order
_CELL_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]

# Work of the renders since a caller last zeroed them: camera bounce
# iterations, photon maps built, gathers (camera bounce x photon pass), and
# over the maps' cells (0-d tensors after a render, read without a host
# sync during it): the most photons in one cell, the cells and the cells
# past _CELL_CAP, whose surplus photons no query takes.
counters = {"camera_bounces": 0, "maps": 0, "gathers": 0, "max_cell": 0, "cells": 0,
            "cells_over_cap": 0}


# --- exact wavelength-only chain re-evaluation --------------------------------


def _log_factors(scene: Scene, lam):
    """Every color program at ``lam`` (any shape), as (log|f_m|, sign flags,
    zero flags): three [*lam.shape, M] float arrays. A zero factor has log 0
    and its zero flag (the JAX package clamps |f| to 1e-37 instead)."""
    shape = lam.shape
    flat = lam.reshape(-1)
    inputs = ProgramInputs(wavelength=flat)
    logs, negs, zeros = [], [], []
    for prog in scene.color_programs:
        val = prog(inputs).expand(flat.shape)
        mag = torch.abs(val)
        zero = mag == 0.0
        logs.append(torch.log(torch.where(zero, 1.0, mag)))
        negs.append((val < 0.0).to(torch.float32))
        zeros.append(zero.to(torch.float32))
    m = len(logs)

    def stack(rows):
        if not rows:
            return torch.zeros(shape + (0,), device=lam.device)
        return torch.stack(rows, dim=-1).reshape(shape + (m,))

    return stack(logs), stack(negs), stack(zeros)


def _chain_eval(counts, scalar, log_f, neg_f, zero_f):
    """scalar x prod_m f_m ^ counts[m], in log space with the sign's parity;
    0 where a factor that occurs (count > 0) is 0. counts and the factors
    broadcast over [..., M], scalar over [...]."""
    mag = torch.exp(torch.sum(counts * log_f, dim=-1))
    parity = torch.sum(counts * neg_f, dim=-1)
    sign = 1.0 - 2.0 * torch.remainder(parity, 2.0)
    dead = torch.sum(counts * zero_f, dim=-1) > 0.0
    return torch.where(dead, 0.0, scalar * mag * sign)


def _lamp_chain_counts(scene: Scene, path, m_count):
    """A photon's side of the exact re-evaluation: the parent chain's
    color-program counts [N, L + 1, M] and scalar (probability x brdf)
    prefix products [N, L + 1]; slot t covers slots 0 .. t - 1 (a photon's
    power excludes its own color and brdf, photon_mapping.rs:524-562)."""
    valid = path["valid"]
    factor_s = torch.where(valid, path["probability"] * _effective_brdf(path), 1.0)
    ps = torch.cumprod(factor_s, dim=1)
    ps_parent = torch.cat([torch.ones_like(ps[:, :1]), ps[:, :-1]], dim=1)
    progs = torch.arange(m_count, device=valid.device)
    onehot = ((path["color_prog"].long()[:, :, None] == progs) & valid[:, :, None]).to(torch.float32)
    counts = torch.cumsum(onehot, dim=1)
    counts_parent = torch.cat([torch.zeros_like(counts[:, :1]), counts[:, :-1]], dim=1)
    return counts_parent, ps_parent


# --- the camera walk -----------------------------------------------------------


def _record_camera_vertices(scene, cfg, draws, origin, direction, wavelengths, bank_vals,
                            chain_m=None):
    """The camera pass's walk (CameraBounce chains, photon_mapping.rs:107-148):
    bounce_dense(record, chain) until no lane is alive or cfg.bounces, as
    photon.py:208-222 ends it. ``draws`` keys the bounce draws (an
    rng.KeyedDraws of the chunk's pixels). Returns (final state, one dict
    of [N] / [N, ...] vertex arrays per bounce taken: valid (a diffuse
    reflection), position, normal, incident, partialR [N, S'] (the chain's
    product up to and including this bounce's color x probability, not its
    brdf), dispersed; with ``chain_m`` (the number of color programs) also
    counts [N, M] (the chain's color programs, this bounce's included) and
    scalar [N] (its wavelength-independent part))."""
    n, s_count = wavelengths.shape
    dev = wavelengths.device
    state = initial_state(origin, direction, s_count)
    chain_r = torch.ones((n, s_count), device=dev)
    counts = torch.zeros((n, chain_m or 0), device=dev)
    scalar = torch.ones(n, device=dev)
    progs = torch.arange(chain_m or 0, device=dev)
    vertices = []
    for i in range(cfg.bounces):
        live = int(state["alive"].sum())
        if live == 0:
            break
        tracer.lane_bounces["live"] += live
        tracer.lane_bounces["executed"] += n
        draws_i = tracer.draw_bounce_uniforms(scene, cfg, n, draws, i, dev)
        state, info = kernels_dense.bounce_dense(scene, cfg, wavelengths, state, draws_i, bank_vals,
                                                 record=True, chain=True)
        counters["camera_bounces"] += 1
        refl = info["reflected"]
        partial_r = torch.where(refl[:, None], chain_r * info["color_prob"], chain_r)
        chain_r = torch.where(refl[:, None], partial_r * info["brdf_stored"][:, None], chain_r)
        vertex = {
            "valid": info["is_diffuse"], "position": info["position"], "normal": info["normal"],
            "incident": info["incident"], "partialR": partial_r, "dispersed": info["dispersed"],
        }
        if chain_m is not None:
            counts = counts + ((info["color_prog"].long()[:, None] == progs)
                               & refl[:, None]).to(torch.float32)
            v_scalar = torch.where(refl, scalar * info["path_prob"], scalar)
            scalar = torch.where(refl, v_scalar * info["brdf_stored"], scalar)
            vertex.update(counts=counts, scalar=v_scalar)
        vertices.append(vertex)
    return state, vertices


# --- the hash grid -------------------------------------------------------------


def _hash(x, y, z):
    """The cell key x 73856093 ^ y 19349663 ^ z 83492791 of int32 cell
    coordinates, its products wrapping as int32 products do."""
    h = ((x.long() * _HASH[0]) ^ (y.long() * _HASH[1]) ^ (z.long() * _HASH[2])) & 0xFFFFFFFF
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _hash_cells(positions, radius):
    """(cell key [...], cell [..., 3] int32) of each position: floor of the
    position over the radius, a true f32 division (PyTorch on CUDA turns a
    division by a Python number into a product with its reciprocal)."""
    cell = torch.floor(positions / torch.full_like(positions, radius)).to(torch.int32)
    return _hash(cell[..., 0], cell[..., 1], cell[..., 2]), cell


def grid_sort_photons(p_pos, p_valid, radius):
    """The photon side of the hash grid: (order [P], sorted keys [P] int32),
    invalid photons keyed INT32_MAX, sorted stably (as jnp.argsort)."""
    keys, _ = _hash_cells(p_pos, radius)
    keys = torch.where(p_valid, keys, _INT32_MAX)
    sorted_keys, order = torch.sort(keys, stable=True)
    return order, sorted_keys


def grid_query(sorted_keys, q_pos, radius):
    """The query side: (starts [N, 27], the 27 neighbour cells' keys [N,
    27] int32) of each query point, starts the first index of each key in
    the sorted keys (searchsorted, left)."""
    _, q_cell = _hash_cells(q_pos, radius)
    offsets = torch.tensor(_CELL_OFFSETS, dtype=torch.int32, device=q_pos.device)
    cells = q_cell[:, None, :] + offsets[None]
    ckeys = _hash(cells[..., 0], cells[..., 1], cells[..., 2])
    starts = torch.searchsorted(sorted_keys, ckeys.reshape(-1)).reshape(ckeys.shape)
    return starts, ckeys


def grid_scan_slot(k, order, sorted_keys, starts, ckeys, p_valid, p_pos, q_pos, radius):
    """Scan step k (cell k // _CELL_CAP, slot k % _CELL_CAP) of each query:
    (photon index [N], in-radius mask [N]). The index is clipped to P - 1 as
    the JAX package clips it. Scanning all 27 _CELL_CAP steps takes every
    photon within the radius once where no cell holds more than
    _CELL_CAP."""
    c, slot = divmod(k, _CELL_CAP)
    idx = torch.clamp(starts[:, c] + slot, 0, p_pos.shape[0] - 1)
    pj = order[idx]
    diff = p_pos[pj] - q_pos
    match = (sorted_keys[idx] == ckeys[:, c]) & p_valid[pj]
    return pj, match & (geom.dot(diff, diff) <= radius * radius)


def cell_occupancy(sorted_keys):
    """Over a map's occupied cells (keys < INT32_MAX): (the most photons in
    one cell, the cells, the cells past _CELL_CAP), 0-d int64 tensors, with
    no host sync."""
    valid = sorted_keys != _INT32_MAX
    idx = torch.arange(sorted_keys.shape[0], device=sorted_keys.device)
    first = torch.ones_like(valid)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first &= valid
    run = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values + 1
    run = torch.where(valid, run, 0)
    return run.max() if run.numel() else run.sum(), first.sum(), (run == _CELL_CAP + 1).sum()


def interp_cols(rows, span, lam):
    """Linear interpolation of ``rows`` [..., B], sampled at the B bin
    centres of ``span``, at wavelengths ``lam`` [..., K] (or [...] for
    one), the leading dimensions broadcast; clamped to the end bins."""
    b = rows.shape[-1]
    lo, hi = span
    squeeze = lam.dim() == rows.dim() - 1
    if squeeze:
        lam = lam[..., None]
    batch = torch.broadcast_shapes(rows.shape[:-1], lam.shape[:-1])
    rows, lam = rows.expand(batch + (b,)), lam.expand(batch + lam.shape[-1:])
    t = torch.clamp((lam - lo) / torch.full_like(lam, (hi - lo) / b) - 0.5, 0.0, b - 1.0)
    i0 = torch.clamp(t.to(torch.int32), max=b - 2).long()
    f = t - i0
    v0 = torch.take_along_dim(rows, i0, dim=-1)
    v1 = torch.take_along_dim(rows, i0 + 1, dim=-1)
    out = v0 + (v1 - v0) * f
    return out[..., 0] if squeeze else out


# --- the photons -----------------------------------------------------------------


@dataclass(frozen=True)
class GatherSpec:
    """What a gather needs besides its inputs: the radius, the film's span
    and bins, S (the fresh wavelengths a pair exposes, K, and the first
    grid column of partialR, g0), G (grid columns), exact mode and the
    photons' power columns (1, or 1 + the film's bins)."""

    radius: float
    span: tuple
    bins: int
    spectrum_samples: int
    g_bins: int
    exact: bool
    power_cols: int


def photon_batch(scene, photon_cfg, draws, lam_p, spec: GatherSpec, bin_centers):
    """Shoot one photon per row of ``lam_p`` [count, 1], each lamp path's
    one wavelength (rng.photon_wavelengths), traced in column 0 so that its
    power is exact there; interpolation mode also traces the film's bin
    centres in the other columns. Walked by tracer.trace_lamp_path (the
    lamp kernels on a GPU) with ``draws``: the photon pass's rng.KeyedDraws
    (photon index in the pixel word), or given draws as trace_lamp_path
    takes them. Returns the [count (L + 1)] photon arrays: position,
    incident (after the reference's pairs() reversal), power [.., C],
    wavelength, valid (a valid diffuse vertex: the emitter is no photon),
    dispersed, and in exact mode counts [.., M] and scalar."""
    count = lam_p.shape[0]
    wl = lam_p if spec.exact else torch.cat([lam_p, bin_centers[None, :].expand(count, spec.bins)],
                                           dim=1)
    bank = kernels_dense.precompute_bank_values(scene, wl)
    path = trace_lamp_path(scene, photon_cfg, draws, wl, bank)
    slots = path["valid"].shape[1]
    pp, _, _, inc = _lamp_path_factors(scene, path, wl, bank)
    # a photon's power: its own probability times its parent chain's
    # product (accumulate_light, photon_mapping.rs:524-562)
    pp_parent = torch.cat([torch.ones_like(pp[:, :1]), pp[:, :-1]], dim=1)
    power = path["probability"][:, :, None] * pp_parent

    def flat(x):
        return x.reshape((count * slots,) + x.shape[2:])

    out = {
        "position": flat(path["position"]), "incident": flat(inc),
        "power": power.reshape(count * slots, wl.shape[1]),
        "wavelength": lam_p.expand(count, slots).reshape(-1),
        "valid": flat(path["valid"] & path["is_diffuse"]), "dispersed": flat(path["dispersed"]),
    }
    if spec.exact:
        counts_parent, ps_parent = _lamp_chain_counts(scene, path, len(scene.color_programs))
        out["counts"] = flat(counts_parent)
        out["scalar"] = flat(path["probability"] * ps_parent)
    return out


def shoot_photons(scene, photon_cfg, draws, count, spec: GatherSpec, bin_centers, chunk):
    """A photon pass's ``count`` photons (photon_batch), traced ``chunk`` at
    a time (photon_chunk). The keyed ``draws`` take the photon index in the
    pixel word, so each chunk's photons are the whole batch's, in order."""
    lam_p = rng.photon_wavelengths(draws, count, spec.span, scene.device)
    parts = [photon_batch(scene, photon_cfg, replace(draws, pixel0=draws.pixel0 + c),
                          lam_p[c:c + chunk], spec, bin_centers) for c in range(0, count, chunk)]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}


def build_map(scene, photons, spec: GatherSpec):
    """A photon map: the photons in cell order (grid_sort_photons), each
    field gathered into that order once, and in exact mode every color
    program's factors at each photon's own wavelength. Keys are the sorted
    int32 cell keys."""
    order, keys = grid_sort_photons(photons["position"], photons["valid"], spec.radius)
    pm = {"keys": keys.contiguous()}
    for k, v in photons.items():
        pm[k] = v[order].contiguous()
    if spec.exact:
        pm["log_f"], pm["neg_f"], pm["zero_f"] = (
            t.contiguous() for t in _log_factors(scene, pm["wavelength"]))
    biggest, cells, over = cell_occupancy(keys)
    counters["maps"] += 1
    counters["max_cell"] = torch.maximum(torch.as_tensor(counters["max_cell"], device=keys.device),
                                         biggest)
    counters["cells"] = counters["cells"] + cells
    counters["cells_over_cap"] = counters["cells_over_cap"] + over
    return pm


# --- the gather ------------------------------------------------------------------


def gather_query(scene, vertex, spec: GatherSpec, lam0, lam_f, factors0=None):
    """One camera bounce's inputs to a gather (photon_gather): the vertex's
    position, normal, incident direction, valid and dispersed flags and
    partialR row, the lanes' hero wavelength ``lam0`` [N] and fresh
    wavelengths ``lam_f`` [N, K]; in exact mode also its counts and scalar,
    the color programs' factors at lam0 (``factors0``, _log_factors of
    lam0: log_f0, neg_f0, zero_f0 [N, M]) and at lam_f (log_ff, neg_ff,
    zero_ff [N, K, M])."""
    q = {k: vertex[k].contiguous() for k in ("position", "normal", "incident", "valid",
                                              "dispersed", "partialR")}
    q["lam0"], q["lam_f"] = lam0.contiguous(), lam_f.contiguous()
    if spec.exact:
        q["counts"], q["scalar"] = vertex["counts"].contiguous(), vertex["scalar"].contiguous()
        q["log_f0"], q["neg_f0"], q["zero_f0"] = (t.contiguous() for t in factors0)
        q["log_ff"], q["neg_ff"], q["zero_ff"] = (
            t.contiguous() for t in _log_factors(scene, q["lam_f"]))
    return q


def gather_plain(spec: GatherSpec, pm, q):
    """The plain version of photon_gather_kernel, on any device
    (photon.py:391-468): for each valid camera vertex, the 27 neighbour
    cells of the hash grid, up to _CELL_CAP photons each in the JAX
    package's scan order; each photon within the radius counts in
    num_neighbors, and a pair (not both dispersed) adds r x p x g to the
    film bin of its primary wavelength (acc_bins, cnt_bins [N, B]), and
    where neither dispersed its fresh sums (fresh_psum [N, K], fresh_cnt).
    Returns that dict. Each cell's 32 slots are evaluated together and
    added slot by slot, in the kernel's order."""
    n = q["position"].shape[0]
    dev = q["position"].device
    s, b, k_fresh, g = spec.spectrum_samples, spec.bins, spec.spectrum_samples, spec.g_bins
    p_count = pm["keys"].shape[0]
    out = {
        "acc_bins": torch.zeros((n, b), device=dev), "cnt_bins": torch.zeros((n, b), device=dev),
        "num_neighbors": torch.zeros(n, dtype=torch.int32, device=dev),
        "fresh_psum": torch.zeros((n, k_fresh), device=dev),
        "fresh_cnt": torch.zeros(n, dtype=torch.int32, device=dev),
    }
    if p_count == 0:
        return out
    lo, hi = spec.span
    pos, normal, valid, cam_disp = q["position"], q["normal"], q["valid"], q["dispersed"]
    r_hero = q["partialR"][:, 0]
    r_grid = q["partialR"][:, s:s + g]
    lam0, lam_f = q["lam0"], q["lam_f"]
    starts, ckeys = grid_query(pm["keys"], pos, spec.radius)
    cos_cam = torch.clamp(geom.dot(q["incident"], -normal), min=0.0)
    pi = torch.full_like(cos_cam, math.pi)
    slot = torch.arange(_CELL_CAP, device=dev)
    for c in range(27):
        idx = torch.clamp(starts[:, c:c + 1] + slot, 0, p_count - 1)  # [N, 32]
        diff = pm["position"][idx] - pos[:, None, :]
        in_rad = ((pm["keys"][idx] == ckeys[:, c:c + 1]) & pm["valid"][idx]
                  & (geom.dot(diff, diff) <= spec.radius * spec.radius) & valid[:, None])
        if not bool(in_rad.any()):
            continue
        out["num_neighbors"] += in_rad.sum(dim=1).to(torch.int32)
        p_disp = pm["dispersed"][idx]
        pair = in_rad & ~(cam_disp[:, None] & p_disp)
        exit_dir = -pm["incident"][idx]
        w_geom = torch.clamp(geom.dot(exit_dir, normal[:, None, :]), min=0.0)
        w_geom = w_geom * cos_cam[:, None] / pi[:, None]
        first_brdf = 2.0 * torch.abs(geom.dot(normal[:, None, :], exit_dir))
        gw = first_brdf * w_geom
        rows = pm["power"][idx]  # [N, 32, C]
        lam_p = pm["wavelength"][idx]
        disp = cam_disp[:, None].expand_as(pair)
        lam_sel = torch.where(disp, lam0[:, None], lam_p)
        if spec.exact:
            p_counts, p_scalar = pm["counts"][idx], pm["scalar"][idx]
            r_at_p = _chain_eval(q["counts"][:, None, :], q["scalar"][:, None], pm["log_f"][idx],
                                 pm["neg_f"][idx], pm["zero_f"][idx])
            p_at_0 = _chain_eval(p_counts, p_scalar, q["log_f0"][:, None, :], q["neg_f0"][:, None, :],
                                 q["zero_f0"][:, None, :])
            r_sel = torch.where(disp, r_hero[:, None], r_at_p)
            p_sel = torch.where(disp, p_at_0, rows[..., 0])
            p_f = _chain_eval(p_counts[:, :, None, :], p_scalar[:, :, None], q["log_ff"][:, None],
                              q["neg_ff"][:, None], q["zero_ff"][:, None])  # [N, 32, K]
        else:
            r_sel = torch.where(disp, r_hero[:, None], interp_cols(r_grid, spec.span, lam_p))
            p_sel = torch.where(disp, interp_cols(rows[..., 1:], spec.span, lam0[:, None]), rows[..., 0])
            p_f = interp_cols(rows[..., 1:], spec.span, lam_f[:, None, :].expand(n, _CELL_CAP, k_fresh))
        contrib = torch.where(pair, r_sel * p_sel * gw, 0.0)
        j = torch.clamp(((lam_sel - lo) * (b / (hi - lo))).to(torch.int32), 0, b - 1).long()
        both_clear = pair & ~disp & ~p_disp
        fresh = torch.where(both_clear[..., None], p_f * gw[..., None], 0.0)
        live = pair.to(torch.float32)
        for sl in range(_CELL_CAP):
            out["acc_bins"].scatter_add_(1, j[:, sl:sl + 1], contrib[:, sl:sl + 1])
            out["cnt_bins"].scatter_add_(1, j[:, sl:sl + 1], live[:, sl:sl + 1])
            out["fresh_psum"] += fresh[:, sl]
        out["fresh_cnt"] += both_clear.sum(dim=1).to(torch.int32)
    return out


def _gather(scene, film, spec, photon_probability, darkness_denom, vertices, wl_cam, fresh, pm,
            acc, wt, positions):
    """The radius gather of one chunk's camera vertices against one photon
    map, and its exposures (photon.py:310-517): per camera bounce i the
    fresh wavelengths ``fresh(i)`` (lam_f [N, K], lam_dark [N, K + 1]; a
    render's are rng.fresh_wavelengths of the photon pass's keyed draws of
    the chunk), the gather (kernels_dense.photon_gather:
    photon_gather_kernel on a GPU, gather_plain on the CPU), then the
    primary samples binned by wavelength, the fresh samples and, where a
    valid vertex gathered nothing, spectrum_samples + 1 dark samples, each
    at weight photon_probability / num_neighbors (1 / darkness_denom for
    the dark ones), through expose_sums. Updates acc and wt in place."""
    n = wl_cam.shape[0]
    dev = wl_cam.device
    k_fresh, b = spec.spectrum_samples, spec.bins
    lo, hi = spec.span
    bin_centers = lo + (torch.arange(b, device=dev, dtype=torch.float32) + 0.5) * ((hi - lo) / b)
    centers = bin_centers[None, :].expand(n, b)
    lam0 = wl_cam[:, 0].contiguous()
    factors0 = _log_factors(scene, lam0) if spec.exact else None
    for i, vertex in enumerate(vertices):
        lam_f, lam_dark = fresh(i)
        q = gather_query(scene, vertex, spec, lam0, lam_f, factors0)
        got = kernels_dense.photon_gather(spec, pm, q)
        counters["gathers"] += 1
        valid, num = q["valid"], got["num_neighbors"]
        has = num > 0
        w1 = torch.full((n,), photon_probability, device=dev) / torch.clamp(num, min=1).to(torch.float32)
        # primary samples, already binned by their wavelength
        expose_sums(film, acc, wt, positions, centers, got["acc_bins"] * w1[:, None],
                    got["cnt_bins"] * w1[:, None], (valid & has)[:, None] & (got["cnt_bins"] > 0.0))
        # fresh samples: R_cam(lam_f) x the pairs' sum of P(lam_f) g
        if spec.exact:
            r_f = _chain_eval(q["counts"][:, None, :], q["scalar"][:, None], q["log_ff"], q["neg_ff"],
                              q["zero_ff"])
        else:
            s = spec.spectrum_samples
            r_f = interp_cols(q["partialR"][:, s:s + spec.g_bins], spec.span, lam_f)
        fresh_ok = (valid & has & (got["fresh_cnt"] > 0))[:, None].expand(n, k_fresh)
        expose_sums(film, acc, wt, positions, lam_f, r_f * got["fresh_psum"] * w1[:, None],
                    (got["fresh_cnt"] * w1)[:, None].expand(n, k_fresh), fresh_ok)
        # no neighbours: spectrum_samples + 1 samples of zero brightness at
        # fresh wavelengths (photon_mapping.rs:403-414)
        dark = valid & ~has
        dark_w = torch.where(dark, 1.0 / darkness_denom, 0.0)
        expose_sums(film, acc, wt, positions, lam_dark, torch.zeros_like(lam_dark),
                    dark_w[:, None].expand(n, k_fresh + 1), dark[:, None].expand(n, k_fresh + 1))
    return acc, wt


# Device memory one step may hold beside the scene's textures and the
# sample's photon maps: 8 GiB of the 80 GB card, as
# bidirectional._STEP_BYTES.
_STEP_BYTES = 8 << 30


def lane_bytes(scene, settings, spec: GatherSpec) -> int:
    """Bytes a camera lane of a photon render holds: its walk's
    (simple.lane_bytes at S + G columns), each bounce's recorded vertex
    (position, normal, incident, flags, partialR [S + G] and in exact mode
    counts [M] and scalar), and one gather's inputs and outputs (fresh
    wavelengths and their factors [K, M] x 3, the bins [B] x 2 and their
    exposure's temporaries)."""
    cols = spec.spectrum_samples + spec.g_bins
    m = len(scene.color_programs) if spec.exact else 0
    k = spec.spectrum_samples
    vertex = 4 * (9 + cols + 1) + 2 + (4 * (m + 1) if spec.exact else 0)
    gather = 4 * (3 * k * m + 3 * m + 2 * k + 2 + 6 * spec.bins)
    return (camera_lane_bytes(scene, cols, settings.light_samples) + settings.bounces * vertex
            + gather)


def map_bytes(settings, spec: GatherSpec, m_count) -> int:
    """Bytes of one sample's photon maps: passes x photons x (photon
    bounces + 1) entries of key, position, incident, power [C], wavelength
    and flags, and in exact mode counts, scalar and the factors [M] x 3;
    twice that while a map is sorted."""
    per = 4 * (1 + 3 + 3 + spec.power_cols + 1) + 2 + (4 * (4 * m_count + 1) if spec.exact else 0)
    return 2 * settings.photon_passes * settings.photons * (settings.photon_bounces + 1) * per


# the fewest photons a lamp walk traces at once (photon_chunk)
_MIN_WALK = 1024


def photon_chunk(scene, settings, held: int = 0) -> int:
    """Photons a lamp walk traces at once: all of a pass's, unless its march
    passes' t rows (DE_T_BYTES a DE shape for each photon's ray, the part
    of the walk that grows with the scene's shapes) pass _STEP_BYTES beside
    ``held`` bytes (textures and photon maps); then as many as fit, at
    least _MIN_WALK."""
    per = DE_T_BYTES * len(scene.de_shapes)
    if per == 0:
        return settings.photons
    return min(settings.photons, max(max(_STEP_BYTES - held, 0) // per, _MIN_WALK))


def pick_rows_per_chunk(film: Film, per_lane: int, held: int = 0) -> int:
    """Camera rows per chunk: the whole film where its lanes fit _STEP_BYTES
    beside ``held`` bytes (textures and photon maps), else the largest
    divisor of the height that fits."""
    lanes = max(film.width, max(_STEP_BYTES - held, 0) // max(per_lane, 1))
    rows = max(1, min(film.height, lanes // film.width))
    while film.height % rows:
        rows -= 1
    return rows


def _build_parts(project_data, scene: Scene):
    """(film, camera, camera cfg, photon cfg, GatherSpec, photon
    probability, darkness denominator, grid centres, bin centres)."""
    project = project_data.project
    settings = project.renderer
    film = Film(width=project.image.width, height=project.image.height,
                bins=settings.spectrum_bins, span=settings.spectrum_span)
    camera = CameraModel.from_ir(project.camera)
    cfg = TraceConfig(bounces=settings.bounces, light_samples=settings.light_samples,
                      spectrum_samples=settings.spectrum_samples)
    photon_cfg = TraceConfig(bounces=settings.photon_bounces, light_samples=0,
                             spectrum_samples=settings.spectrum_samples)
    widths = scene.photon_widths
    if widths is None:
        raise ValueError("the scene was not built from a photon-mapping project (build_scene "
                         "decides its chain mode and checks its rows)")
    g_bins = widths["camera"] - settings.spectrum_samples
    spec = GatherSpec(radius=settings.radius, span=tuple(settings.spectrum_span),
                      bins=settings.spectrum_bins, spectrum_samples=settings.spectrum_samples,
                      g_bins=g_bins, exact=widths["exact"], power_cols=widths["lamp"])
    photon_probability = 1.0 / (settings.bounces * settings.photon_bounces * settings.photon_passes)
    darkness_denom = float(settings.bounces * settings.photon_passes)
    lo, hi = settings.spectrum_span
    dev = scene.device

    def centers(count):
        return torch.tensor([lo + (i + 0.5) * (hi - lo) / count for i in range(count)],
                            dtype=torch.float32, device=dev)

    return (film, camera, cfg, photon_cfg, spec, photon_probability, darkness_denom,
            centers(g_bins), centers(settings.spectrum_bins))


def camera_pass(scene, film, camera, cfg, spec, grid_centers, draws, row0, rows, acc, wt):
    """A chunk's camera pass (photon.py:633-663): its rays (keyed by
    ``draws``, the camera sample), the walk recording its vertices, traced
    with the interpolation grid appended to the film columns (not in exact
    mode), and the camera samples exposed as the simple renderer's (the hero
    always, the other columns while never dispersed). Returns (acc, wt,
    vertices, positions, the walk's wavelengths [N, S + G])."""
    dev = scene.device
    positions, origin, direction, wl = chunk_rays(film, camera, cfg, draws, row0=row0, rows=rows,
                                                  device=dev)
    n, s = wl.shape
    wl_ext = wl if spec.exact else torch.cat(
        [wl, grid_centers[None, :].expand(n, spec.g_bins)], dim=1).contiguous()
    bank = kernels_dense.precompute_bank_values(scene, wl_ext)
    keyed = replace(draws, pixel0=row0 * film.width)
    state, vertices = _record_camera_vertices(
        scene, cfg, keyed, origin, direction, wl_ext, bank,
        chain_m=len(scene.color_programs) if spec.exact else None)
    brightness = state["brightness"][:, :s]
    mask = tracer._column_mask(state["aux_alive"], s)
    acc, wt = expose_lanes(film, acc, wt, row0, wl, brightness, torch.ones_like(brightness), mask)
    return acc, wt, vertices, positions, wl_ext


def render(project_data, scene: Scene, seed: int = 0, on_progress=None, max_samples=None,
           resume=None):
    """Render the project with progressive photon mapping on the scene's
    device; returns (film, acc, wt). Per sample: every photon pass's map
    (shoot_photons, build_map), then per chunk of camera rows
    (pick_rows_per_chunk under lane_bytes) the camera pass and its gather
    against each map in pass order. ``resume`` (a checkpoint) starts from
    its film at its samples_done; the draws are keyed by the global sample,
    so the resumed render equals the straight one."""
    return render_sharded(project_data, scene, local_mesh(scene.device), seed=seed,
                          on_progress=on_progress, max_samples=max_samples, resume=resume)


def render_sharded(project_data, scene: Scene, mesh, seed: int = 0, on_progress=None,
                   max_samples=None, resume=None):
    """render on one rank of ``mesh`` (parallel.mesh), the scene built on
    its device: one sample a rank a round (run_sharded), each rank building
    its own samples' photon maps. Every rank returns the merged film; with
    ``on_progress`` the films are merged after every round and rank 0 alone
    reports."""
    settings = project_data.project.renderer
    (film, camera, cfg, photon_cfg, spec, photon_probability, darkness_denom, grid_centers,
     bin_centers) = _build_parts(project_data, scene)
    held = scene.texture_bytes + map_bytes(settings, spec, len(scene.color_programs))
    rows = pick_rows_per_chunk(film, lane_bytes(scene, settings, spec), held)
    walk = photon_chunk(scene, settings, held)
    acc, wt = device_film_buffers(film, mesh, resume)
    start = _uniform_start(resume, film)
    total = settings.pixel_samples if max_samples is None else min(settings.pixel_samples,
                                                                   max_samples)
    passes = settings.photon_passes

    def step(acc, wt, first, count):
        for i in range(first, first + count):
            base = i * (1 + passes)
            photon_draws = [KeyedDraws(seed, sample0=base + 1 + p) for p in range(passes)]
            maps = [build_map(scene, shoot_photons(scene, photon_cfg, d, settings.photons, spec,
                                                   bin_centers, walk), spec)
                    for d in photon_draws]
            for row0 in range(0, film.height, rows):
                acc, wt, vertices, positions, wl_cam = camera_pass(
                    scene, film, camera, cfg, spec, grid_centers, KeyedDraws(seed, sample0=base),
                    row0, rows, acc, wt)
                n = wl_cam.shape[0]
                for d, pm in zip(photon_draws, maps):
                    keyed = replace(d, pixel0=row0 * film.width)
                    fresh = lambda bounce, keyed=keyed: rng.fresh_wavelengths(  # noqa: E731
                        keyed, n, bounce, spec.spectrum_samples, spec.span, scene.device)
                    _gather(scene, film, spec, photon_probability, darkness_denom, vertices,
                            wl_cam, fresh, pm, acc, wt, positions)
        return acc, wt

    progress = None if on_progress is None else (lambda done, a, w: on_progress(RenderProgress(
        sample=done, total=total, acc=a, wt=w, film=film, lane_samples=_uniform_lanes(film, done))))
    return (film, *run_sharded(step, mesh, acc, wt, start, total, 1, progress))
