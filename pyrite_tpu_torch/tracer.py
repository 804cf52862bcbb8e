"""Wavefront path tracer core (PyTorch port of pyrite_tpu.tracer).

A whole wavefront of rays advances one bounce per step: intersection
against the planes and either a brute-force sweep of the (at most 128)
finite primitives of a dense scene or a walk of the clustered wide BVH of a
mesh scene (``cluster_traverse``), branchless material component selection
and BSDF scattering,
next-event estimation, and streaming radiance accumulation (the recurrence of
renderer/algorithm.rs:14-100, fused into the loop as in the JAX package).

Distance-estimated shapes are sphere-traced after the primitives
(``intersect_de``; ``march_de_plain`` is the plain version of the CUDA march
in csrc/march_de.cuh, which kernels.march_de launches alone and
kernels_dense.march_pass / shadow_pass over a bounce's rays, ``de_hits``
their plain version).

``bounce_core`` is the plain PyTorch version of the CUDA bounce and NEE
kernels in csrc/bounce.cu: kernels_dense.bounce_dense runs it for tensors on
the CPU and launches the kernels for tensors on a GPU. ``intersect_scene`` /
``intersect_shadow`` on a mesh scene are the plain versions of the traversal
kernels of csrc/wide_bvh.cu (kernels.closest_wide / shadow_wide). Its random
numbers come in one ``draws`` dict shaped like the JAX package's
draw_bounce_uniforms, so both packages (and both versions) can be fed
identical draws; a render keys them (rng.KeyedDraws).

For the bidirectional renderer, ``bounce_core(record=True)`` also returns
the camera vertex, and the lamp paths are ``trace_lamp_path``'s: the
emitter (``sample_lamp_ray``, ``lamp_start``) and the lamp bounces
(``lamp_bounce_step``), the plain versions of the CUDA lamp kernels, which
kernels_dense.lamp_start / lamp_bounce route to by device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import geometry as geom
from .exprs import ProgramInputs
from .rng import KeyedDraws, bounce_draws
from .scene import (
    BSDF_DIFFUSE,
    BSDF_EMISSIVE,
    BSDF_MIRROR,
    BSDF_REFRACTIVE,
    LAMP_DIRECTIONAL,
    LAMP_POINT,
    LAMP_SPHERE,
    LAMP_TRIANGLE,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    Scene,
)

DIST_EPSILON = geom.DIST_EPSILON

# hit kinds
KIND_NONE = 0
KIND_TRIANGLE = 1
KIND_SPHERE = 2
KIND_PLANE = 3
KIND_DE = 4  # DE shape j encoded as idx = j

# The over-relaxation factor of the DE sphere trace: the JAX package's
# default (kernels.de_omega, chosen there by a cornell A/B); 1.0 is the plain
# march.
DE_OMEGA = 1.6

# Counts for a run to show which route its bounces took: "bounce_core",
# "lamp_start", "lamp_bounce_step" and "intersect_shadow" are the plain
# versions' calls, "bounces" the bounce iterations trace_paths ran and
# "lamp_bounces" those of trace_lamp_path (by either route).
launches = {"bounce_core": 0, "bounces": 0, "lamp_start": 0, "lamp_bounce_step": 0,
            "intersect_shadow": 0, "lamp_bounces": 0}
# Lane-bounces of the bounce loops since a caller last zeroed them:
# "executed", every lane of every bounce iteration; "live", the lanes whose
# path still runs and will be exposed (the alive lanes of trace_paths, of
# the bidirectional camera walk and of the survivor pool, the quota-bound
# lanes of a regeneration launch); "lamp_live" and "lamp_executed", the
# same of the lamp walks (trace_lamp_path).
lane_bounces = {"live": 0, "executed": 0, "lamp_live": 0, "lamp_executed": 0}

# Work the plain version counts while a caller sets this to a dict (None:
# no counting, and no host syncs for it): "de_steps" (march steps of all
# lanes), "de_iterations" (estimator iterations entered), "pops" (wide-BVH
# children popped), "descents" (node rows tested on descending) and
# "leaf_rows" (leaf rows tested); "leaf_visits", one entry per
# cluster_traverse call: {"lane": [V], "slot": [V], "lanes": N}, the batch
# index and leaf slot of each of its V (ray, leaf) sweeps; and "de_orbits",
# one entry per march_de_plain call: {"lane": [K], "step": [K],
# "iterations": [K], "lanes": N}, the estimator iterations of each of its K
# (ray, step) evaluations. chip_smoke.py reads it for the kernels' bounds and
# the warps' divergence.
work = None


def _count(key, amount):
    if work is not None:
        work[key] = work.get(key, 0) + int(amount)


@dataclass(frozen=True)
class TraceConfig:
    bounces: int
    light_samples: int
    spectrum_samples: int
    max_de_steps: int = 200


# =============================================================================
# Intersection: plane scan, then a brute-force primitive sweep (dense
# scenes) or the clustered wide-BVH walk (mesh scenes)
# =============================================================================


def _first_min(t):
    """(row min [N], first column reaching it [N]) of a [N, P] tensor: the
    lowest index wins ties, as in the JAX package's masked first-min."""
    tj = t.min(dim=1).values
    return tj, torch.argmax((t == tj[:, None]).to(torch.int8), dim=1)


def empty_hit(n, device):
    """The running hit before any test: nothing hit, at infinity."""
    return {
        "t": torch.full((n,), math.inf, device=device),
        "kind": torch.full((n,), KIND_NONE, dtype=torch.int32, device=device),
        "idx": torch.zeros(n, dtype=torch.long, device=device),
        "u": torch.zeros(n, device=device),
        "v": torch.zeros(n, device=device),
    }


def intersect_scene(scene: Scene, origin, direction, init=None, de_steps=200):
    """Closest hit for a ray batch, from the running hit ``init`` (empty_hit
    by default). Returns a dict with t, kind, idx, u, v
    (tracer.py:501-552 with _brute_force_triangles/_spheres, or the cluster
    traversal, then the DE shapes); ``idx`` is the plane index, the
    triangle/sphere table index (prim_ref) or the DE shape's index. A DE hit
    counts only beyond DIST_EPSILON and strictly nearer than the hit so far
    (tracer.py:547)."""
    a = scene.arrays
    best = dict(empty_hit(origin.shape[0], origin.device) if init is None else init)

    def take(better, kind, t, idx, u=None, v=None):
        best["t"] = torch.where(better, t, best["t"])
        best["kind"] = torch.where(better, kind, best["kind"])
        best["idx"] = torch.where(better, idx, best["idx"])
        if u is not None:
            best["u"] = torch.where(better, u, best["u"])
            best["v"] = torch.where(better, v, best["v"])

    o = origin[:, None, :]
    d = direction[:, None, :]
    if scene.num_planes > 0:
        _, t = geom.ray_plane(o, d, a["pla_normal"][None], a["pla_d"][None])
        tj, j = _first_min(t)
        take(tj < best["t"], KIND_PLANE, tj, j)
    if scene.use_clusters:
        best = cluster_traverse(scene, origin, direction, best, _cluster_leaf_closest(scene))
    else:
        if scene.num_triangles > 0:
            _, t, u, v = geom.ray_triangle(o, d, a["tri_v0"][None], a["tri_e1"][None], a["tri_e2"][None])
            tj, j = _first_min(t)
            pick = lambda x: torch.gather(x, 1, j[:, None])[:, 0]
            take(tj < best["t"], KIND_TRIANGLE, tj, j, pick(u), pick(v))
        if scene.num_spheres > 0:
            _, t = geom.ray_sphere(o, d, a["sph_center"][None], a["sph_radius"][None])
            tj, j = _first_min(t)
            take(tj < best["t"], KIND_SPHERE, tj, j)
    for j, shape in enumerate(scene.de_shapes):
        ok, t = intersect_de(shape, origin, direction, de_steps)
        take(ok & (t > DIST_EPSILON) & (t < best["t"]), KIND_DE, t, j)
    return best


def intersect_shadow(
    scene: Scene, origin, direction, max_dist, block_below=None, de_steps=200
):
    """Nearest hit distance along shadow rays, starting from ``max_dist``
    (the lamp distance): unoccluded lanes return ``max_dist``.

    ``block_below`` ([N], or None) is the caller's occlusion bound: on a
    mesh scene a lane that finds a hit below it is blocked for sure and
    stops walking (tracer.py:432-498), so its t is then some blocker's, not
    necessarily the nearest. Dense scenes sweep everything and ignore it.
    The DE shapes are marched no further than ``max_dist``, and their hits
    count at any t, negative included (tracer.py:492-496): a shadow ray
    leaving a DE surface is usually blocked by it (ROADMAP.md queue 3)."""
    launches["intersect_shadow"] += 1
    a = scene.arrays
    o = origin[:, None, :]
    d = direction[:, None, :]
    t_best = max_dist
    if scene.num_planes > 0:
        _, t = geom.ray_plane(o, d, a["pla_normal"][None], a["pla_d"][None])
        t_best = torch.minimum(t_best, t.min(dim=1).values)
    if scene.use_clusters:
        t_best = cluster_traverse(
            scene, origin, direction, {"t": t_best}, _cluster_leaf_shadow(scene), block_below
        )["t"]
    else:
        if scene.num_triangles > 0:
            _, t, _, _ = geom.ray_triangle(o, d, a["tri_v0"][None], a["tri_e1"][None], a["tri_e2"][None])
            t_best = torch.minimum(t_best, t.min(dim=1).values)
        if scene.num_spheres > 0:
            _, t = geom.ray_sphere(o, d, a["sph_center"][None], a["sph_radius"][None])
            t_best = torch.minimum(t_best, t.min(dim=1).values)
    for shape in scene.de_shapes:
        _, t = intersect_de(shape, origin, direction, de_steps, t_cap=max_dist)
        t_best = torch.minimum(t_best, t)
    return t_best


# --- the clustered wide BVH ----------------------------------------------------
#
# bvh.build_wide_bvh lays the tree out as 273 rows of 128 floats: the 16
# child boxes of one node as [minx | miny | minz | maxx | maxy | maxz]
# columns, the children's sort axis in column 96 and their validity bitmask
# in column 97. Row 0 is the root, row 1 + i the L1 node i, row 17 + n the
# L2 node n = i * 16 + j, whose child k is the leaf slot n * 16 + k of
# clu_geo. A ray's walk keeps one 16-bit mask of pending children per level
# (m0 of the root, m1 of L1 node cur1, m2 of L2 node cur2), so it needs no
# stack.
#
# The walk here is the plain version of csrc/wide_bvh.cuh and steps in the
# same order: each step takes the deepest non-empty mask, pops its child
# front to back (from the high bit where the ray runs negative along the
# node's sort axis), tests that child's box again against the running best
# t (which re-prunes everything still pending after each leaf), and then
# descends into it or sweeps its leaf. Kernel and plain version therefore
# visit the same leaves in the same order and agree on ties too. The JAX
# package's walk (tracer.py:2271-2676) visits in its own order; the closest
# hit is the same up to ties.


def _bit_tables(device):
    """Index of the lowest and of the highest set bit of every 16-bit mask."""
    m = np.arange(1 << 16)
    low = np.zeros(1 << 16, np.int64)
    high = np.zeros(1 << 16, np.int64)
    for b in range(15, -1, -1):
        low[(m >> b) & 1 == 1] = b
    for b in range(16):
        high[(m >> b) & 1 == 1] = b
    return torch.as_tensor(low, device=device), torch.as_tensor(high, device=device)


_BIT_TABLES: dict = {}


def _child_boxes(row, k):
    """[M, 6] box (lo xyz, hi xyz) of child ``k`` [M] of each row [M, 128]."""
    cols = k[:, None] + torch.arange(0, 96, 16, device=row.device)[None, :]
    return torch.gather(row, 1, cols)


def _slab(lo, hi, origin, inv_dir, t_best):
    """Slab test of boxes against rays (math.rs:184-207; tracer._slab16):
    hit when the exit is not before the entry nor behind the origin and the
    entry lies before ``t_best``. NaN (0 * inf on a ray in a slab plane)
    propagates through the min/max as in the JAX package, so such a box is
    missed."""
    t1 = (lo - origin) * inv_dir
    t2 = (hi - origin) * inv_dir
    tmin = torch.minimum(t1, t2).amax(dim=-2)
    tmax = torch.maximum(t1, t2).amin(dim=-2)
    return (tmax >= tmin) & (tmax >= 0.0) & (torch.clamp(tmin, min=0.0) < t_best)


def _slab16(row, origin, direction, inv_dir, t_best):
    """16-child hit bitmask of each row [M, 128] (tracer._slab16), masked by
    the validity column 97, and the pop direction: whether the ray runs
    negative along the row's sort axis (tracer._axis_sign)."""
    lo = row[:, 0:48].reshape(-1, 3, 16)
    hi = row[:, 48:96].reshape(-1, 3, 16)
    hit = _slab(lo, hi, origin[:, :, None], inv_dir[:, :, None], t_best[:, None])
    weights = torch.tensor([1 << k for k in range(16)], device=row.device)
    bits = (hit.long() * weights).sum(dim=1) & row[:, 97].long()
    d_axis = torch.gather(direction, 1, row[:, 96:97].long())[:, 0]
    return bits, d_axis < 0.0


def cluster_traverse(scene, origin, direction, init_state, leaf_sweep, exit_below=None):
    """Closest-hit or any-hit walk of the clustered wide BVH for a ray
    batch, from ``init_state`` (a dict of [N] tensors with at least "t").

    ``leaf_sweep(slots, origin, direction, state)`` tests the rays of a
    subset against one leaf cluster each and returns their new state.
    ``exit_below`` ([N] or None): a lane stops once its t drops below it
    (checked before the walk and after each leaf). The plain version of the
    traversal kernels; semantics of tracer._cluster_traverse."""
    rows = scene.arrays["wide_rows"]
    dev = origin.device
    if dev not in _BIT_TABLES:
        _BIT_TABLES[dev] = _bit_tables(dev)
    low, high = _BIT_TABLES[dev]
    n = origin.shape[0]
    inv_dir = 1.0 / direction
    state = {k: v.clone() for k, v in init_state.items()}

    m0, ph0 = _slab16(rows[0].expand(n, -1), origin, direction, inv_dir, state["t"])
    if exit_below is not None:
        m0 = torch.where(state["t"] < exit_below, 0, m0)
    visits = [] if work is not None else None
    m1 = torch.zeros_like(m0)
    m2 = torch.zeros_like(m0)
    cur1 = torch.zeros_like(m0)
    cur2 = torch.zeros_like(m0)
    ph1 = torch.zeros_like(ph0)
    ph2 = torch.zeros_like(ph0)
    while True:
        lanes = torch.nonzero((m0 | m1 | m2) != 0)[:, 0]
        if lanes.numel() == 0:
            break
        o, d, inv, t = origin[lanes], direction[lanes], inv_dir[lanes], state["t"][lanes]
        a0, a1, a2 = m0[lanes], m1[lanes], m2[lanes]
        c1, c2 = cur1[lanes], cur2[lanes]
        lvl2 = a2 != 0
        lvl1 = ~lvl2 & (a1 != 0)
        lvl0 = ~lvl2 & ~lvl1
        mask = torch.where(lvl2, a2, torch.where(lvl1, a1, a0))
        from_high = torch.where(lvl2, ph2[lanes], torch.where(lvl1, ph1[lanes], ph0[lanes]))
        k = torch.where(from_high, high[mask], low[mask])
        rest = mask & ~(1 << k)
        m2[lanes] = torch.where(lvl2, rest, a2)
        m1[lanes] = torch.where(lvl1, rest, a1)
        m0[lanes] = torch.where(lvl0, rest, a0)
        _count("pops", lanes.numel())
        # the popped child, tested again against the running best t
        parent = torch.where(lvl2, 17 + c2, torch.where(lvl1, 1 + c1, 0))
        box = _child_boxes(rows[parent], k)
        ok = _slab(box[:, 0:3, None], box[:, 3:6, None], o[:, :, None], inv[:, :, None], t[:, None])[:, 0]

        # descend: an L1 node fills m1, an L2 node fills m2
        down = ok & ~lvl2
        _count("descents", down.sum())
        if bool(down.any()):
            sel = lanes[down]
            node = torch.where(lvl1, c1 * 16 + k, k)[down]
            into2 = lvl1[down]
            bits, sign = _slab16(
                rows[torch.where(into2, 17 + node, 1 + node)], o[down], d[down], inv[down], t[down]
            )
            m2[sel] = torch.where(into2, bits, m2[sel])
            ph2[sel] = torch.where(into2, sign, ph2[sel])
            cur2[sel] = torch.where(into2, node, cur2[sel])
            m1[sel] = torch.where(into2, m1[sel], bits)
            ph1[sel] = torch.where(into2, ph1[sel], sign)
            cur1[sel] = torch.where(into2, cur1[sel], node)

        # sweep a leaf
        sweep = ok & lvl2
        _count("leaf_rows", sweep.sum() * scene.cluster_leaf)
        if bool(sweep.any()):
            sel = lanes[sweep]
            slots = (c2 * 16 + k)[sweep]
            if visits is not None:
                visits.append((sel, slots))
            sub = {key: v[sel] for key, v in state.items()}
            new = leaf_sweep(slots, origin[sel], direction[sel], sub)
            for key, v in new.items():
                state[key][sel] = v
            if exit_below is not None:
                done = sel[new["t"] < exit_below[sel]]
                m0[done] = 0
                m1[done] = 0
                m2[done] = 0
    if visits is not None:
        none = torch.zeros(0, dtype=torch.long, device=dev)
        work.setdefault("leaf_visits", []).append({
            "lane": torch.cat([none] + [v[0] for v in visits]),
            "slot": torch.cat([none] + [v[1] for v in visits]),
            "lanes": n,
        })
    return state


def _leaf_hits(scene, slots, origin, direction):
    """Every primitive of one leaf cluster per ray: (t [M, L] with inf where
    missed, u, v, kind, ref) of the clu_geo rows (tracer._leaf_geometry and
    the tests of _cluster_leaf_closest). Rows of kind -1 pad the leaf."""
    g = scene.arrays["clu_geo"][slots]  # [M, L, 12]
    o = origin[:, None, :]
    d = direction[:, None, :]
    tri_ok, tri_t, u, v = geom.ray_triangle(o, d, g[..., 0:3], g[..., 3:6], g[..., 6:9])
    sph_ok, sph_t = geom.ray_sphere(o, d, g[..., 0:3], g[..., 9])
    kind = g[..., 10]
    is_tri = kind == PRIM_TRIANGLE
    ok = torch.where(is_tri, tri_ok, sph_ok & (kind == PRIM_SPHERE))
    t = torch.where(ok, torch.where(is_tri, tri_t, sph_t), math.inf)
    return t, u, v, is_tri, g[..., 11]


def _cluster_leaf_closest(scene):
    """Closest-hit leaf sweep: the first minimum inside the leaf replaces
    the running hit only when strictly nearer (tracer.py:2746-2779)."""

    def leaf_sweep(slots, origin, direction, state):
        t, u, v, is_tri, ref = _leaf_hits(scene, slots, origin, direction)
        tj, j = _first_min(t)
        pick = lambda x: torch.gather(x, 1, j[:, None])[:, 0]
        better = tj < state["t"]
        won_tri = pick(is_tri)
        return {
            "t": torch.where(better, tj, state["t"]),
            "kind": torch.where(
                better,
                torch.where(won_tri, KIND_TRIANGLE, KIND_SPHERE).to(state["kind"].dtype),
                state["kind"],
            ),
            "idx": torch.where(better, pick(ref).to(state["idx"].dtype), state["idx"]),
            "u": torch.where(better, torch.where(won_tri, pick(u), 0.0), state["u"]),
            "v": torch.where(better, torch.where(won_tri, pick(v), 0.0), state["v"]),
        }

    return leaf_sweep


def _cluster_leaf_shadow(scene):
    """Any-hit leaf sweep: the running minimum t."""

    def leaf_sweep(slots, origin, direction, state):
        t, _, _, _, _ = _leaf_hits(scene, slots, origin, direction)
        return {"t": torch.minimum(state["t"], t.min(dim=1).values)}

    return leaf_sweep


# --- distance-estimated shapes --------------------------------------------------
#
# The plain version of csrc/march_de.cuh, one torch op for each op of the
# JAX package's estimator (tracer.py:92-240 and kernels.py:758-901, which
# agree) in the same order, so that on the card the kernel, which calls the
# same libm functions with --fmad=false, follows it ulp for ulp as far as the
# two libms agree. Orbits are chaotic, so a last-ulp difference can still
# move a point's escape to another iteration: callers compare hit flags and
# t, never raw distances.


def _f32(x):
    """A parameter rounded to f32 as the JAX package's weakly typed scalars
    are, held as an exact Python float."""
    return float(np.float32(x))


def _de_mandelbulb(est, px, py, pz):
    power = _f32(est["power"])
    power_m1 = _f32(float(est["power"]) - 1.0)
    threshold = _f32(est["threshold"])
    constant = est["constant"]
    dc = 1.0 if constant is None else 0.0
    cx, cy, cz = (px, py, pz) if constant is None else (_f32(c) for c in constant[:3])
    zx, zy, zz = px, py, pz
    r = torch.zeros_like(px)
    dr = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    iterations = torch.zeros_like(px, dtype=torch.int32)
    for _ in range(est["iterations"]):
        if work is not None:
            _count("de_iterations", (~done).sum())
            iterations += ~done
        r_new = torch.sqrt(torch.clamp(zx * zx + zy * zy + zz * zz, min=1e-30))
        done_now = done | (r_new > threshold)
        theta = torch.acos(torch.clamp(zz / r_new, -1.0, 1.0)) * power
        phi = geom.atan2(zy, zx) * power
        dr_new = geom.power(r_new, power_m1) * power * dr + dc
        zr = geom.power(r_new, power)
        st = torch.sin(theta)
        nx = st * torch.cos(phi) * zr + cx
        ny = torch.sin(phi) * st * zr + cy
        nz = torch.cos(theta) * zr + cz
        keep = ~done_now
        zx, zy, zz = (torch.where(keep, n, o) for n, o in ((nx, zx), (ny, zy), (nz, zz)))
        r = torch.where(done, r, r_new)
        dr = torch.where(keep, dr_new, dr)
        done = done_now
    return 0.5 * torch.log(torch.clamp(r, min=1e-30)) * r / dr, iterations


def _qmul(a, b):
    s1, x1, y1, z1 = a
    s2, x2, y2, z2 = b
    return (
        s1 * s2 - x1 * x2 - y1 * y2 - z1 * z2,
        s1 * x2 + x1 * s2 + y1 * z2 - z1 * y2,
        s1 * y2 - x1 * z2 + y1 * s2 + z1 * x2,
        s1 * z2 + x1 * y2 - y1 * x2 + z1 * s2,
    )


def _qsq(q):
    """z * z of a quaternion, which commutes with itself: (s^2 - |v|^2, 2 s v)."""
    s, x, y, z = q
    v2 = x * x + y * y + z * z
    s2 = s + s
    return (s * s - v2, s2 * x, s2 * y, s2 * z)


def _bmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return (
        x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2,
        x1 * y2 + y1 * x2 - z1 * w2 - w1 * z2,
        x1 * z2 - y1 * w2 + z1 * x2 - w1 * y2,
        x1 * w2 + y1 * z2 + z1 * y2 + w1 * x2,
    )


def _bsq(q):
    x, y, z, w = q
    return (
        x * x - y * y - z * z + w * w,
        2.0 * (x * y - z * w),
        2.0 * (x * z - y * w),
        2.0 * (x * w + y * z),
    )


def _de_julia(est, px, py, pz):
    """Quaternion Julia (distance_estimators.rs:44-94): z = (x, y, z, slice),
    the square shared and the derivative re-associated ((dz z) z = dz z^2),
    the escape radius carried squared."""
    variant = est["variant"]
    consts = [_f32(c) for c in est["constant"]]
    thr2 = _f32(float(est["threshold"]) * float(est["threshold"]))
    z = (px, py, pz, torch.full_like(px, _f32(est["slice_plane"])))
    zero = torch.zeros_like(px)
    dz = (torch.ones_like(px), zero, zero, zero)
    r2 = zero
    done = torch.zeros_like(px, dtype=torch.bool)
    iterations = torch.zeros_like(px, dtype=torch.int32)
    for _ in range(est["iterations"]):
        if work is not None:
            _count("de_iterations", (~done).sum())
            iterations += ~done
        r2_new = z[0] * z[0] + z[1] * z[1] + z[2] * z[2] + z[3] * z[3]
        done_now = done | (r2_new > thr2)
        if variant == "regular":
            zp, dz_new = _qsq(z), tuple(c * 2.0 for c in _qmul(dz, z))
        elif variant == "cubic":
            q2 = _qsq(z)
            zp, dz_new = _qmul(q2, z), tuple(c * 3.0 for c in _qmul(dz, q2))
        else:  # bicomplex
            zp = _bsq(z)
            dz_new = tuple(c * 2.0 for c in _bmul(dz, zp))
        keep = ~done_now
        z = tuple(torch.where(keep, c + k, o) for c, k, o in zip(zp, consts, z))
        dz = tuple(torch.where(keep, n, o) for n, o in zip(dz_new, dz))
        r2 = torch.where(done, r2, r2_new)
        done = done_now
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    dz_mag = torch.sqrt(torch.clamp(dz[0] * dz[0] + dz[1] * dz[1] + dz[2] * dz[2] + dz[3] * dz[3], min=1e-30))
    return 0.5 * torch.log(torch.clamp(r, min=1e-30)) * r / dz_mag, iterations


def _de_orbits(est, p):
    """(distance estimate, estimator iterations each point ran, counted
    while tracer.work counts, else 0)."""
    fn = _de_mandelbulb if est["kind"] == "mandelbulb" else _de_julia
    return fn(est, p[..., 0], p[..., 1], p[..., 2])


def de_distance(est: dict, p):
    """The distance estimate of the shape ``est`` (scene.DEShape.estimator)
    at local points p [..., 3] (shapes/distance_estimators.rs)."""
    return _de_orbits(est, p)[0]


def march_de_plain(est, local_origin, direction, t0, tmax, hit, max_steps, omega=DE_OMEGA):
    """Sphere trace along each ray in the shape's local space, from t0 while
    t < tmax and the last safe distance is at least DIST_EPSILON, at most
    ``max_steps`` steps: the two loops of tracer._intersect_de
    (tracer.py:280-344, identical to the TPU kernel kernels.py:907). With
    omega > 1 each step is omega * d, stepping back to the plain step from
    the previous point when consecutive step spheres stop overlapping, and
    no relaxed step leaps past tmax; ``dist`` tracks safe evaluations only.
    A lane that stops never changes again, so only the active lanes are
    evaluated at each step. Returns (total, dist) [N]."""
    omega = _f32(omega)
    total = t0.clone()
    dist = torch.full_like(t0, math.inf)
    relaxed = omega > 1.0
    s_prev = torch.zeros_like(t0)
    d_prev = torch.full_like(t0, 1e30)
    active = hit & (total < tmax) & (dist >= DIST_EPSILON)
    orbits = []  # (lanes, step, iterations) of each step, while counting
    for step in range(max_steps):
        lanes = torch.nonzero(active)[:, 0]
        if lanes.numel() == 0:
            break
        _count("de_steps", lanes.numel())
        tot, tm = total[lanes], tmax[lanes]
        d, iterations = _de_orbits(est, local_origin[lanes] + direction[lanes] * tot[:, None])
        if work is not None:
            orbits.append((lanes, torch.full_like(lanes, step), iterations))
        if relaxed:
            sp, dp = s_prev[lanes], d_prev[lanes]
            unsafe = sp > dp + d
            t_revert = tot - sp + dp
            step = omega * d
            step = torch.where(tot + step > tm, d, step)
            tot = torch.where(unsafe, t_revert, tot + step)
            dist[lanes] = torch.where(unsafe, dist[lanes], d)
            s_prev[lanes] = torch.where(unsafe, dp, step)
            d_prev[lanes] = torch.where(unsafe, dp, d)
        else:
            tot = tot + d
            dist[lanes] = d
        total[lanes] = tot
        active[lanes] = (tot < tm) & (dist[lanes] >= DIST_EPSILON)
    if work is not None:
        empty = torch.zeros(0, dtype=torch.long, device=t0.device)
        lane, step, iterations = (torch.cat(x) for x in zip(*orbits)) if orbits else (empty,) * 3
        work.setdefault("de_orbits", []).append(
            {"lane": lane, "step": step, "iterations": iterations, "lanes": t0.shape[0]})
    return total, dist


def _de_bounds(shape, origin, direction):
    """(hit, tmin, tmax, center) of each ray against the shape's bounding
    volume (tracer.py:254-263)."""
    dev = origin.device
    center = torch.as_tensor(shape.center, device=dev)
    if shape.bounds_kind == "box":
        lo = torch.as_tensor(shape.bounds_a, device=dev)
        hi = torch.as_tensor(shape.bounds_b, device=dev)
        hit, tmin, tmax = geom.ray_aabb_range(origin, direction, lo, hi)
    else:
        hit, tmin, tmax = geom.ray_sphere_range(origin, direction, center, float(shape.bounds_b[0]))
    return hit, tmin, tmax, center


def intersect_de(shape, origin, direction, max_steps, omega=DE_OMEGA, t_cap=None, march=None):
    """Sphere tracing within the shape's bounding volume (shapes/mod.rs:
    120-155, tracer._intersect_de): (ok, t) with t = inf where missed.
    ``t_cap`` ([N]) caps the march at that distance (the lamp distance of a
    shadow ray). ``march`` is march_de_plain, or kernels.march_de to run
    the march in its CUDA kernel."""
    hit, tmin, tmax, center = _de_bounds(shape, origin, direction)
    if t_cap is not None:
        tmax = torch.minimum(tmax, t_cap)
    total0 = torch.where(hit, tmin, math.inf)
    total, _ = (march or march_de_plain)(
        shape.estimator, origin - center, direction, total0, tmax, hit, max_steps, omega
    )
    ok = hit & (total <= tmax)
    return ok, torch.where(ok, total, math.inf)


def de_hits(scene: Scene, origin, direction, max_steps, t_cap=None, live=None):
    """intersect_de's t of every DE shape of the scene along each ray,
    [n_de, N]: inf where the ray misses the shape, and where ``live`` ([N]
    bool, or None for all) is False. The plain version of march_de_kernel's
    passes over a bounce's rays and its shadow rays
    (kernels_dense.march_pass / shadow_pass)."""
    rows = [intersect_de(shape, origin, direction, max_steps, t_cap=t_cap)[1]
            for shape in scene.de_shapes]
    t = torch.stack(rows) if rows else origin.new_empty((0, origin.shape[0]))
    return t if live is None else torch.where(live, t, math.inf)


def de_normal(shape, origin, direction, t):
    """The normal of a DE hit: central differences of the estimator, eps =
    DIST_EPSILON, at the point DIST_EPSILON short of the hit in the shape's
    local space (tracer.py:665-695, shapes/mod.rs:138)."""
    center = torch.as_tensor(shape.center, device=origin.device)
    local = (origin - center) + direction * (t - DIST_EPSILON)[:, None]
    offsets = torch.cat([torch.eye(3) * DIST_EPSILON, -torch.eye(3) * DIST_EPSILON]).to(local.device)
    probes = (local[None, :, :] + offsets[:, None, :]).reshape(-1, 3)
    d6 = de_distance(shape.estimator, probes).reshape(6, -1)
    return geom.normalize(torch.stack([d6[0] - d6[3], d6[1] - d6[4], d6[2] - d6[5]], dim=-1))


def surface_data(scene: Scene, hit, origin, direction, frames=False):
    """Per-hit surface attributes, branchless across hit kinds.

    Returns (position, normal, material_id); with ``frames`` (position,
    normal, frame quaternion [N, 4], uv [N, 2], material_id), as the JAX
    package's surface_data (tracer.py:612-697): a triangle's frame is the
    barycentric blend of its vertex quaternions, then normalised, and its
    uv the blend of its vertex uv; a sphere's from its latitude and
    longitude (geometry.sphere_surface_frame); a plane's its own, with the
    position rotated into it as uv; a DE hit's de_normal_quat of its
    normal, uv 0. A DE hit's normal is de_normal's, evaluated on the DE
    lanes only."""
    a = scene.arrays
    t = hit["t"]
    safe_t = torch.where(torch.isfinite(t), t, 0.0)
    position = origin + direction * safe_t[:, None]
    kind = hit["kind"]
    idx = hit["idx"]

    def rows(table):
        return a[table][torch.clamp(idx, max=a[table].shape[0] - 1)]

    u = hit["u"][:, None]
    v = hit["v"][:, None]
    w = (1.0 - hit["u"] - hit["v"])[:, None]
    tn = rows("tri_n")  # [N, 3, 3]
    tri_normal = geom.normalize(tn[:, 0] * w + tn[:, 1] * u + tn[:, 2] * v)
    s_center = rows("sph_center")
    sph_normal = geom.normalize(position - s_center)
    p_norm = rows("pla_normal")

    k = kind[:, None]

    def by_kind(tri, sph, pla, other):
        return torch.where(k == KIND_TRIANGLE, tri, torch.where(
            k == KIND_SPHERE, sph, torch.where(k == KIND_PLANE, pla, other)))

    normal = by_kind(tri_normal, sph_normal, p_norm, 0.0)
    mat = torch.zeros_like(idx)
    for kd, table in ((KIND_TRIANGLE, "tri_mat"), (KIND_SPHERE, "sph_mat"), (KIND_PLANE, "pla_mat")):
        mat = torch.where(kind == kd, rows(table).long(), mat)
    if frames:
        tq, tuv = rows("tri_q"), rows("tri_uv")
        tri_quat = geom.quat_normalize(tq[:, 0] * w + tq[:, 1] * u + tq[:, 2] * v)
        tri_uv = tuv[:, 0] * w + tuv[:, 1] * u + tuv[:, 2] * v
        _, sph_quat, sph_uv = geom.sphere_surface_frame(position, s_center, rows("sph_texscale"))
        p_quat = rows("pla_quat")
        p_uv = geom.plane_uv(position, p_quat, rows("pla_texscale"))
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=position.device).expand(kind.shape[0], 4)
        quat = by_kind(tri_quat, sph_quat, p_quat, ident)
        uv = by_kind(tri_uv, sph_uv, p_uv, 0.0)
    for j, shape in enumerate(scene.de_shapes):
        sel = (kind == KIND_DE) & (idx == j)
        lanes = torch.nonzero(sel)[:, 0]
        if lanes.numel():
            normal[lanes] = de_normal(shape, origin[lanes], direction[lanes], safe_t[lanes])
            mat[lanes] = shape.material_id
            if frames:
                quat[lanes] = geom.de_normal_quat(normal[lanes])
    if frames:
        return position, normal, quat, uv, mat
    return position, normal, mat


def apply_normal_maps(scene: Scene, mat_id, normal, quat, inputs: ProgramInputs):
    """Material normal mapping (materials/mod.rs:68-81, tracer.py:796-815):
    the material's vector program, rotated by the hit's frame and
    normalised, replaces the normal; a vector with |v|^2 < 1e-12 keeps the
    geometric one. Normal programs read no wavelength: the first spectral
    column's value is taken."""
    if not scene.normal_programs:
        return normal
    prog_id = scene.arrays["mat_normal_prog"][mat_id]
    out = normal
    for p, prog in enumerate(scene.normal_programs):
        mask = (prog_id == p)[:, None]
        vec = prog(inputs)
        if vec.ndim == 3:
            vec = vec[:, 0, :]
        vec = vec.expand(normal.shape[0], 4)[:, :3]
        mapped = geom.normalize(geom.quat_rotate(quat, vec))
        degenerate = geom.dot(vec, vec) < 1e-12
        out = torch.where(mask & ~degenerate[:, None], mapped, out)
    return out


# =============================================================================
# Program banks
# =============================================================================


def _bank_table_eval(table, span, prog_id, wavelength):
    """Linear interpolation of the baked [P, G] bank table at each lane's
    wavelengths (scene.bake_bank_tables)."""
    g = table.shape[1]
    lo, hi = span
    pos = torch.clamp((wavelength - lo) * ((g - 1) / (hi - lo)), 0.0, g - 1.0)
    i0 = torch.clamp(pos.long(), max=g - 2)
    frac = pos - i0.to(torch.float32)
    base = torch.clamp(prog_id, min=0)[:, None] * g + i0
    flat = table.reshape(-1)
    v0 = flat[base]
    v1 = flat[base + 1]
    return v0 + (v1 - v0) * frac


def eval_color_bank(scene: Scene, prog_id, inputs: ProgramInputs, active=None):
    """Per-ray color programs: out[i] = program[prog_id[i]](inputs), [N, S]."""
    out = torch.zeros_like(inputs.wavelength)
    baked = scene.color_bank_bakeable
    if baked is not None:
        val = _bank_table_eval(
            scene.arrays["color_bank"], scene.bank_span, prog_id, inputs.wavelength
        )
        in_table = torch.as_tensor(baked, device=prog_id.device)[torch.clamp(prog_id, min=0)]
        mask = in_table & (prog_id >= 0)
        if active is not None:
            mask = mask & active
        out = out + torch.where(mask[:, None], val, 0.0)
    for p, prog in enumerate(scene.color_programs):
        if baked is not None and baked[p]:
            continue
        mask = prog_id == p
        if active is not None:
            mask = mask & active
        val = prog(inputs)
        out = out + torch.where(mask[:, None], val.expand(out.shape), 0.0)
    return out


def eval_prob_bank(scene: Scene, prog_id, inputs: ProgramInputs, active=None):
    """Per-ray probability programs at the hero wavelength -> [N]."""
    n = inputs.wavelength.shape[0]
    out = torch.ones(n, device=inputs.wavelength.device)  # no program (-1): 1
    hero_inputs = ProgramInputs(
        wavelength=inputs.wavelength[:, :1],
        normal=inputs.normal,
        incident=inputs.incident,
        uv=inputs.uv,
    )
    baked = scene.prob_bank_bakeable
    if baked is not None:
        val = _bank_table_eval(
            scene.arrays["prob_bank"], scene.bank_span, prog_id, hero_inputs.wavelength
        )[:, 0]
        mask = torch.as_tensor(baked, device=prog_id.device)[torch.clamp(prog_id, min=0)]
        mask = mask & (prog_id >= 0)
        if active is not None:
            mask = mask & active
        out = torch.where(mask, val, out)
    for p, prog in enumerate(scene.prob_programs):
        if baked is not None and baked[p]:
            continue
        mask = prog_id == p
        if active is not None:
            mask = mask & active
        val = prog(hero_inputs).expand(n, 1)[:, 0]
        out = torch.where(mask, val, out)
    return out


# =============================================================================
# BSDF scattering (materials/{diffuse,mirror,refractive}.rs)
# =============================================================================


def scatter(scene: Scene, comp_idx, direction, normal, hero_wl, u):
    """Branchless scatter across all BSDF types. ``u``: [N, 3] uniforms."""
    a = scene.arrays
    bsdf = a["comp_bsdf"][comp_idx]

    d_dot_n = geom.dot(direction, normal)
    flipped = torch.where((d_dot_n < 0.0)[:, None], normal, -normal)

    diff_out = geom.sample_hemisphere(u[:, 0], u[:, 1], flipped)
    mirror_out = direction - flipped * (2.0 * geom.dot(direction, flipped))[:, None]

    # refractive (refractive.rs:46-91); wavelength in micrometres for Cauchy
    wl = hero_wl * 0.001
    ior = a["comp_ior"][comp_idx] + a["comp_disp"][comp_idx] / (wl * wl)
    env_ior = a["comp_env_ior"][comp_idx] + a["comp_env_disp"][comp_idx] / (wl * wl)
    refr_dispersed = (a["comp_disp"][comp_idx] != 0.0) | (a["comp_env_disp"][comp_idx] != 0.0)

    nl = flipped
    n_dot_d = geom.dot(normal, direction)
    reflected = direction - normal * (2.0 * n_dot_d)[:, None]
    into = geom.dot(normal, nl) > 0.0
    nnt = torch.where(into, env_ior / ior, ior / env_ior)
    ddn = geom.dot(direction, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    s_sign = torch.where(into, 1.0, -1.0)
    s_val = s_sign * (ddn * nnt + torch.sqrt(torch.clamp(cos2t, min=0.0)))
    tdir = geom.normalize(direction * nnt[:, None] - normal * s_val[:, None])
    a_ = ior - env_ior
    b_ = ior + env_ior
    r0 = (a_ * a_) / (b_ * b_)
    c_ = 1.0 - torch.where(into, -ddn, geom.dot(tdir, normal))
    c2 = c_ * c_
    re = r0 + (1.0 - r0) * (c2 * c2 * c_)
    tr = 1.0 - re
    p_refl = 0.25 + 0.5 * re
    pick_reflect = u[:, 2] < p_refl
    refr_out = torch.where((tir | pick_reflect)[:, None], reflected, tdir)
    refr_prob = torch.where(
        tir, 1.0, torch.where(pick_reflect, re / p_refl, tr / (1.0 - p_refl))
    )

    is_diffuse = bsdf == BSDF_DIFFUSE
    is_mirror = bsdf == BSDF_MIRROR
    is_refr = bsdf == BSDF_REFRACTIVE
    out_dir = torch.where(
        is_diffuse[:, None], diff_out, torch.where(is_mirror[:, None], mirror_out, refr_out)
    )
    return {
        "out_dir": out_dir,
        "probability": torch.where(is_refr, refr_prob, 1.0),
        "dispersed": is_refr & refr_dispersed,
        "is_specular": is_mirror | is_refr,
        "is_diffuse": is_diffuse,
        "is_emissive": bsdf == BSDF_EMISSIVE,
    }


def brdf_value(normal, out_dir, is_diffuse):
    """Lambertian 2|n.out| for diffuse bounces, 1 for specular."""
    return torch.where(is_diffuse, 2.0 * torch.abs(geom.dot(normal, out_dir)), 1.0)


# =============================================================================
# Next-event estimation (tracer.rs:347-442) and lamp sampling (lamp.rs:23-82)
# =============================================================================


def sample_lamp(scene: Scene, lamp_idx, target, u):
    """Sample one lamp toward ``target`` (lamp.rs:23-82), branchless over
    the directional/point/sphere/triangle lamps present. ``u``: [N, 4]
    uniforms. A directional lamp's direction is a cone sample about its own
    direction where its width (a cosine) is above 0, else that direction;
    its sq_distance is inf and its weight 1. The sample's surface uv
    ("surf_uv", for textured emitters) is computed where the scene's
    programs read uv (scene.frames), else 0."""
    a = scene.arrays
    ltype = a["lamp_type"][lamp_idx]
    lvec = a["lamp_vec"][lamp_idx]
    n = target.shape[0]
    dev = target.device

    direction = torch.zeros((n, 3), device=dev)
    sq_distance = torch.full((n,), math.inf, device=dev)
    weight = torch.ones(n, device=dev)
    surf_normal = torch.zeros((n, 3), device=dev)
    surf_uv = torch.zeros((n, 2), device=dev)
    surf_mat = torch.zeros(n, dtype=torch.long, device=dev)

    is_pt = ltype == LAMP_POINT
    is_sph = ltype == LAMP_SPHERE
    is_tri = ltype == LAMP_TRIANGLE

    if LAMP_DIRECTIONAL in scene.lamp_types:
        width = a["lamp_width"][lamp_idx]
        cone = geom.sample_cone(u[:, 0], u[:, 1], lvec, width)
        dir_dir = torch.where((width > 0.0)[:, None], cone, lvec)
        direction = torch.where((ltype == LAMP_DIRECTIONAL)[:, None], dir_dir, direction)

    if LAMP_POINT in scene.lamp_types:
        v_pt = lvec - target
        pt_sqd = geom.dot(v_pt, v_pt)
        direction = torch.where(is_pt[:, None], geom.normalize(v_pt), direction)
        sq_distance = torch.where(is_pt, pt_sqd, sq_distance)
        weight = torch.where(is_pt, 4.0 * math.pi / torch.clamp(pt_sqd, min=1e-20), weight)

    ref = torch.clamp(a["lamp_ref"][lamp_idx].long(), min=0)

    if LAMP_SPHERE in scene.lamp_types:
        # sphere shape (shapes/mod.rs:209-271)
        sref = torch.clamp(ref, max=a["sph_center"].shape[0] - 1)
        s_center = a["sph_center"][sref]
        s_radius_full = a["sph_radius"][sref]
        s_radius = torch.clamp(s_radius_full - DIST_EPSILON, min=0.0)
        dir_to_c = s_center - target
        dist2 = geom.dot(dir_to_c, dir_to_c)
        outside = dist2 > s_radius * s_radius
        cos_theta_max = torch.sqrt(
            torch.clamp(1.0 - (s_radius * s_radius) / torch.clamp(dist2, min=1e-20), min=0.0)
        )
        cone_dir = geom.sample_cone(u[:, 0], u[:, 1], geom.normalize(dir_to_c), cos_theta_max)
        # the cone comes from the epsilon-reduced radius, the sample point
        # from intersecting the FULL sphere (as in the JAX package)
        cone_hit, cone_t = geom.ray_sphere(target, cone_dir, s_center, s_radius_full)
        cone_t = torch.where(cone_hit, cone_t, 0.0)
        sph_point_out = target + cone_dir * cone_t[:, None]
        unit = geom.sample_sphere(u[:, 0], u[:, 1])
        sph_point_in = s_center + unit * s_radius_full[:, None]
        sph_point = torch.where(outside[:, None], sph_point_out, sph_point_in)
        sph_v = sph_point - target
        sph_sqd = torch.where(outside, cone_t * cone_t, geom.dot(sph_v, sph_v))
        sph_dir = torch.where(outside[:, None], cone_dir, geom.normalize(sph_v))
        cos_full = torch.sqrt(
            torch.clamp(
                1.0 - (s_radius_full * s_radius_full) / torch.clamp(dist2, min=1e-20), min=0.0
            )
        )
        sph_normal = geom.normalize(sph_point - s_center)
        if scene.frames:
            _, _, sph_uv = geom.sphere_surface_frame(sph_point, s_center, a["sph_texscale"][sref])
            surf_uv = torch.where(is_sph[:, None], sph_uv, surf_uv)
        sph_area = s_radius_full * s_radius_full * 4.0 * math.pi
        cos_in_sph = torch.abs(geom.dot(sph_normal, -sph_dir))
        sph_weight = torch.where(
            dist2 > s_radius_full * s_radius_full,
            geom.solid_angle(cos_full),
            cos_in_sph * sph_area / torch.clamp(sph_sqd, min=1e-20),
        )
        direction = torch.where(is_sph[:, None], sph_dir, direction)
        sq_distance = torch.where(is_sph, sph_sqd, sq_distance)
        weight = torch.where(is_sph, sph_weight, weight)
        surf_normal = torch.where(is_sph[:, None], sph_normal, surf_normal)
        surf_mat = torch.where(is_sph, a["sph_mat"][sref].long(), surf_mat)

    if LAMP_TRIANGLE in scene.lamp_types:
        # triangle shape: uniform point (shapes/mod.rs:180-207)
        tref = torch.clamp(ref, max=a["tri_v0"].shape[0] - 1)
        t_v0 = a["tri_v0"][tref]
        t_e1 = a["tri_e1"][tref]
        t_e2 = a["tri_e2"][tref]
        tu = u[:, 0]
        tv = u[:, 1]
        fold = tu + tv > 1.0
        tu = torch.where(fold, 1.0 - tu, tu)
        tv = torch.where(fold, 1.0 - tv, tv)
        tri_point = t_v0 + t_e1 * tu[:, None] + t_e2 * tv[:, None]
        tri_v = tri_point - target
        tri_sqd = geom.dot(tri_v, tri_v)
        tri_dir = geom.normalize(tri_v)
        tw = 1.0 - tu - tv
        tn = a["tri_n"][tref]
        tri_normal = geom.normalize(
            tn[:, 0] * tw[:, None] + tn[:, 1] * tu[:, None] + tn[:, 2] * tv[:, None]
        )
        if scene.frames:
            tuv = a["tri_uv"][tref]
            tri_uv = tuv[:, 0] * tw[:, None] + tuv[:, 1] * tu[:, None] + tuv[:, 2] * tv[:, None]
            surf_uv = torch.where(is_tri[:, None], tri_uv, surf_uv)
        c = geom.cross(t_e1, t_e2)
        tri_area = 0.5 * torch.sqrt(torch.clamp(geom.dot(c, c), min=0.0))
        cos_in_tri = torch.abs(geom.dot(tri_normal, -tri_dir))
        tri_weight = cos_in_tri * tri_area / torch.clamp(tri_sqd, min=1e-20)
        direction = torch.where(is_tri[:, None], tri_dir, direction)
        sq_distance = torch.where(is_tri, tri_sqd, sq_distance)
        weight = torch.where(is_tri, tri_weight, weight)
        surf_normal = torch.where(is_tri[:, None], tri_normal, surf_normal)
        surf_mat = torch.where(is_tri, a["tri_mat"][tref].long(), surf_mat)

    return {
        "direction": direction,
        "sq_distance": sq_distance,
        "weight": weight,
        "is_shape": is_sph | is_tri,
        "surf_normal": surf_normal,
        "surf_uv": surf_uv,
        "surf_mat": surf_mat,
        "color_prog": a["lamp_color"][lamp_idx].long(),
    }


def choose_emissive(scene: Scene, mat_id, u):
    """Uniformly pick an emissive component of a material
    (materials/mod.rs:56-62). Returns (component index, selection comp)."""
    a = scene.arrays
    count = torch.clamp(a["mat_emis_count"][mat_id].long(), min=1)
    pick = torch.minimum((u * count).long(), count - 1)
    eidx = a["mat_emis_offset"][mat_id].long() + pick
    return a["emis_comp"][eidx].long(), a["emis_selection"][eidx]


def draw_bounce_uniforms(scene: Scene, cfg: TraceConfig, n, draws, bounce, device):
    """All of one bounce's random draws, in the layout of the JAX package's
    draw_bounce_uniforms (tracer.py:1069-1091): u_comp [N], u_scatter [N, 3],
    lamp_idx [N] int32, u_nee [ls, N, 4], u_emis [ls, N]. ``draws`` is an
    rng.KeyedDraws: the draws are keyed per (pixel, sample, bounce, purpose),
    one philox_draws_kernel launch on a CUDA device (rng.bounce_draws)."""
    return bounce_draws(draws, n, bounce, cfg.light_samples, scene.num_lamps, device)


def trace_direct(
    scene: Scene, cfg: TraceConfig, draws, active, position, normal, ray_in,
    wavelengths, reflectance, aux_alive,
):
    """Direct-light (NEE) contribution for the current bounce: brightness
    delta [N, S], summed over the light samples in order. ``reflectance`` is
    the throughput after the surface color multiply (tracer.rs:362-399)."""
    delta = torch.zeros_like(reflectance)
    if scene.num_lamps == 0 or cfg.light_samples == 0:
        return delta
    ls = cfg.light_samples
    lamp_idx = draws["lamp_idx"].long()
    probability = 1.0 / (ls * 2.0 * math.pi * (1.0 / scene.num_lamps))
    flip = torch.where((geom.dot(ray_in, normal) < 0.0)[:, None], normal, -normal)
    for s in range(ls):
        delta = delta + _direct_sample(
            scene, cfg, probability, active, position, flip, wavelengths, reflectance,
            aux_alive, lamp_idx, draws["u_nee"][s], draws["u_emis"][s],
        )
    return delta


def _direct_sample(
    scene, cfg, probability, active, position, flip, wavelengths, reflectance,
    aux_alive, lamp_idx, u, u_emis,
):
    """One NEE sample: lamp sample -> shadow -> emissive component ->
    program banks -> masked contribution [N, S]."""
    n, s_count = reflectance.shape
    a = scene.arrays
    samp = sample_lamp(scene, lamp_idx, position, u)

    cos_out = torch.clamp(geom.dot(flip, samp["direction"]), min=0.0)
    contributes = active & (cos_out > 0.0)

    e_comp, e_sel = choose_emissive(scene, samp["surf_mat"], u_emis)
    target_normal = torch.where(samp["is_shape"][:, None], samp["surf_normal"], -samp["direction"])
    prob_inputs = ProgramInputs(
        wavelength=wavelengths, normal=target_normal, incident=samp["direction"],
        uv=samp["surf_uv"],
    )
    mat_prob = eval_prob_bank(scene, a["comp_prob"][e_comp], prob_inputs, active=contributes) * e_sel
    mat_prob = torch.where(samp["is_shape"], mat_prob, 1.0)
    l_dispersed = samp["is_shape"] & a["comp_prob_uses_wl"][e_comp]
    color_prog = torch.where(samp["is_shape"], a["comp_color"][e_comp].long(), samp["color_prog"])
    l_color = eval_color_bank(scene, color_prog, prob_inputs, active=contributes)

    brdf = 2.0 * torch.abs(geom.dot(flip, samp["direction"]))
    scale = samp["weight"] * probability * brdf
    contrib = l_color * (scale * mat_prob)[:, None] * reflectance
    # hero always contributes; auxiliaries only while alive and when the
    # lamp's material probability didn't read the wavelength
    col_mask = _column_mask(aux_alive & ~l_dispersed, s_count)

    # shadow ray, seeded at the lamp distance, stopping at the first blocker
    # below the occlusion bound (tracer.py:1269-1270)
    block_below = torch.sqrt(torch.clamp(samp["sq_distance"] - DIST_EPSILON, min=0.0))
    t_hit = intersect_shadow(
        scene, position, samp["direction"], torch.sqrt(samp["sq_distance"]), block_below,
        cfg.max_de_steps,
    )
    has_hit = torch.isfinite(t_hit)
    hit_sq = torch.where(has_hit, t_hit * t_hit, math.inf)
    blocked = has_hit & (hit_sq < samp["sq_distance"] - DIST_EPSILON)
    ok = contributes & ~blocked
    return torch.where(ok[:, None] & col_mask, contrib, 0.0)


def _column_mask(aux, s_count):
    """[N, S] mask: the hero column always, the others where ``aux``."""
    cols = torch.arange(s_count, device=aux.device)[None, :]
    return (cols == 0) | aux[:, None]


# =============================================================================
# The simple-renderer bounce loop (simple.rs + algorithm.rs, streaming)
# =============================================================================


def initial_state(origin, direction, s_count):
    n = origin.shape[0]
    dev = origin.device
    return {
        "origin": origin,
        "direction": direction,
        "brightness": torch.zeros((n, s_count), device=dev),
        "reflectance": torch.ones((n, s_count), device=dev),
        "alive": torch.ones(n, dtype=torch.bool, device=dev),
        "aux_alive": torch.ones(n, dtype=torch.bool, device=dev),
        "sample_light": torch.ones(n, dtype=torch.bool, device=dev),
        "light_events": torch.zeros(n, dtype=torch.int32, device=dev),
    }


def trace_paths(scene: Scene, cfg: TraceConfig, rng, origin, direction, wavelengths):
    """Trace a wavefront to completion and return per-sample radiance.

    ``wavelengths``: [N, S] with the hero at column 0. ``rng`` is an
    rng.KeyedDraws of the wavefront's samples (bounce i draws with bounce
    i's key, so the early end skips no draw another bounce reads), or a list
    of per-bounce ``draws`` dicts. Every bounce goes through
    kernels_dense.bounce_dense. The loop ends early once no lane is alive.
    Returns (brightness [N, S], aux_alive [N])."""
    from . import kernels_dense

    n = origin.shape[0]
    state = initial_state(origin, direction, wavelengths.shape[1])
    bank_vals = kernels_dense.precompute_bank_values(scene, wavelengths)
    for i in range(cfg.bounces):
        live = int(state["alive"].sum())
        if live == 0:
            break
        lane_bounces["live"] += live
        lane_bounces["executed"] += n
        if isinstance(rng, KeyedDraws):
            draws = draw_bounce_uniforms(scene, cfg, n, rng, i, origin.device)
        else:
            draws = rng[i]
        state = kernels_dense.bounce_dense(scene, cfg, wavelengths, state, draws, bank_vals)
        launches["bounces"] += 1
    return state["brightness"], state["aux_alive"]


def _shading_normal(scene: Scene, hit, o, d, wavelengths):
    """(shading normal, material, position, uv) of each hit: surface_data,
    then the materials' normal maps (apply_normal_maps) on a scene with
    frames; uv None on a scene without."""
    if not scene.frames:
        position, normal, mat_id = surface_data(scene, hit, o, d)
        return normal, mat_id, position, None
    position, normal_geo, quat, uv, mat_id = surface_data(scene, hit, o, d, frames=True)
    inputs = ProgramInputs(wavelength=wavelengths, normal=normal_geo, incident=d, uv=uv)
    return apply_normal_maps(scene, mat_id, normal_geo, quat, inputs), mat_id, position, uv


def bounce_core(scene: Scene, cfg: TraceConfig, wavelengths, state, draws, record=False):
    """One camera-path bounce: intersection, contribution, NEE, scatter
    (tracer.py:1585-1796, dense scenes). The plain version of the CUDA
    bounce and NEE kernels. Returns the new state; with ``record``, (new
    state, info), info the surface interaction a bidirectional connection
    needs (tracer.py:1772-1794): position, normal, incident, is_diffuse,
    dispersed, recorded (a vertex counts toward the path length: a
    reflection, an emission while sampling lamps, or a miss), brdf_stored
    and miss; and the chain factors photon mapping reads, on the lanes that
    reflect (0, -1 and False elsewhere): reflected, color_prob [N, S] (the
    surface color times path_prob), color_prog (the component's color
    program) and path_prob (the scatter and component probability)."""
    launches["bounce_core"] += 1
    n = state["origin"].shape[0]
    s_count = wavelengths.shape[1]
    a = scene.arrays
    alive = state["alive"]
    o = state["origin"]
    d = state["direction"]

    hit = intersect_scene(scene, o, d, de_steps=cfg.max_de_steps)
    found = hit["kind"] != KIND_NONE
    normal, mat_id, position, uv = _shading_normal(scene, hit, o, d, wavelengths)

    # ---- miss: directional lamps, then the sky (tracer.rs:322-342) ---------
    miss = alive & ~found
    sky_inputs = ProgramInputs(wavelength=wavelengths, normal=-d, incident=d,
                               uv=torch.zeros((n, 2), device=d.device))
    miss_color = scene.sky_program(sky_inputs).expand(n, s_count)
    if scene.directional_lamps:
        # the first directional lamp whose direction . ray >= width, while
        # the lane samples lamps; its color program reads the sky's inputs
        taken = torch.zeros(n, dtype=torch.bool, device=d.device)
        dir_color = torch.zeros((n, s_count), device=d.device)
        for lamp_dir, width, color_prog in scene.directional_lamps:
            lamp_dir = torch.as_tensor(lamp_dir, device=d.device).expand(n, 3)
            match = (geom.dot(lamp_dir, d) >= width) & ~taken
            val = scene.color_programs[color_prog](sky_inputs).expand(n, s_count)
            dir_color = dir_color + torch.where(match[:, None], val, 0.0)
            taken |= match
        use_dir = state["sample_light"] & taken
        miss_color = torch.where(use_dir[:, None], dir_color, miss_color)
    aux_cols = _column_mask(state["aux_alive"], s_count)
    brightness = state["brightness"] + torch.where(
        miss[:, None] & aux_cols, miss_color * state["reflectance"], 0.0
    )

    # ---- hit: material interaction -------------------------------------
    hit_active = alive & found

    # uniform component choice (materials/mod.rs:48-54)
    count = torch.clamp(a["mat_comp_count"][mat_id].long(), min=1)
    pick = torch.minimum((draws["u_comp"] * count).long(), count - 1)
    comp = a["mat_comp_offset"][mat_id].long() + pick

    prob_inputs = ProgramInputs(wavelength=wavelengths, normal=normal, incident=d, uv=uv)
    comp_probability = eval_prob_bank(
        scene, a["comp_prob"][comp], prob_inputs, active=hit_active
    ) * a["comp_selection"][comp]
    normal_dispersed = a["comp_prob_uses_wl"][comp]

    sc = scatter(scene, comp, d, normal, wavelengths[:, 0], draws["u_scatter"])
    emitted = hit_active & sc["is_emissive"]
    reflected = hit_active & ~sc["is_emissive"]

    # --- emission (contribute() emission branch) ------------------------
    emit_now = emitted & state["sample_light"]
    aux_emit = _column_mask(state["aux_alive"] & ~normal_dispersed, s_count)
    surface_color = eval_color_bank(scene, a["comp_color"][comp], prob_inputs, active=hit_active)
    brightness = brightness + torch.where(
        emit_now[:, None] & aux_emit,
        surface_color * comp_probability[:, None] * state["reflectance"],
        0.0,
    )

    # --- reflection -----------------------------------------------------
    bounce_dispersed = sc["dispersed"] | normal_dispersed
    aux_alive = state["aux_alive"] & torch.where(reflected, ~bounce_dispersed, True)
    aux_ref_cols = _column_mask(aux_alive, s_count)
    path_prob = sc["probability"] * comp_probability
    refl_mask = reflected[:, None] & aux_ref_cols
    reflectance = torch.where(
        refl_mask, state["reflectance"] * surface_color * path_prob[:, None], state["reflectance"]
    )

    # --- next-event estimation (only the first 2 diffuse events) ---------
    nee_now = reflected & sc["is_diffuse"] & (state["light_events"] < 2)
    if cfg.light_samples > 0:
        brightness = brightness + trace_direct(
            scene, cfg, draws, nee_now, position, normal, d, wavelengths, reflectance, aux_alive
        )
    light_events = state["light_events"] + nee_now.to(torch.int32)
    # sample_light for the *next* bounce (tracer.rs:257-279)
    sample_light = torch.where(
        reflected,
        torch.where(
            state["light_events"] < 2,
            sc["is_specular"] | (cfg.light_samples == 0),
            True,
        ),
        state["sample_light"],
    )

    # --- apply the BRDF and continue the path ------------------------------
    brdf = brdf_value(normal, sc["out_dir"], sc["is_diffuse"])
    reflectance = torch.where(refl_mask, reflectance * brdf[:, None], reflectance)
    new_state = {
        "origin": torch.where(reflected[:, None], position, o),
        "direction": torch.where(reflected[:, None], sc["out_dir"], d),
        "brightness": brightness,
        "reflectance": reflectance,
        "alive": alive & reflected,
        "aux_alive": aux_alive,
        "sample_light": sample_light,
        "light_events": light_events,
    }
    if not record:
        return new_state
    return new_state, {
        "position": position,
        "normal": normal,
        "incident": d,
        "is_diffuse": sc["is_diffuse"] & reflected,
        "dispersed": bounce_dispersed & reflected,
        "recorded": reflected | emit_now | miss,
        "brdf_stored": brdf,
        "miss": miss,
        "reflected": reflected,
        "color_prob": torch.where(reflected[:, None], surface_color * path_prob[:, None], 0.0),
        "color_prog": torch.where(reflected, a["comp_color"][comp].to(torch.int32), -1),
        "path_prob": torch.where(reflected, path_prob, 0.0),
    }


# =============================================================================
# Lamp paths for bidirectional tracing (bidirectional.rs:125-202)
# =============================================================================
#
# A lamp path is recorded as [N, L + 1] vertex arrays (slot 0 the emitter):
# position, normal, color_prog (int32), probability, is_diffuse, dispersed,
# valid, brdf, uv, and incident_out (the direction that arrived at the
# vertex; the emitter's is its start direction), with brdf_limit [N] (the
# last bounce's brdf along its scattered direction) and length [N] (valid
# vertices). Only the valid slots are defined: every consumer masks the
# others out. uv is computed where the scene's programs read it
# (scene.frames), else 0.

LAMP_VERTEX = {  # field: dtype of a recorded vertex
    "position": torch.float32, "normal": torch.float32, "uv": torch.float32,
    "color_prog": torch.int32,
    "probability": torch.float32, "is_diffuse": torch.bool, "dispersed": torch.bool,
    "valid": torch.bool, "brdf": torch.float32,
}


def sample_lamp_ray(scene: Scene, lamp_idx, u):
    """Start lamp subpaths (lamp.rs:84-113, tracer.py:1804-1903): lamp
    ``lamp_idx`` [N] (picked uniformly) samples an outgoing ray from the
    uniforms ``u`` [N, 4], branchless over the point, sphere and triangle
    lamps present. Returns a dict of the emitter's data; "valid" is False
    for a directional lamp (it starts no path) and in a scene without
    lamps."""
    a = scene.arrays
    n = u.shape[0]
    dev = u.device
    lamp_idx = lamp_idx.long()
    ltype = a["lamp_type"][lamp_idx]
    ref = torch.clamp(a["lamp_ref"][lamp_idx].long(), min=0)
    position = torch.zeros((n, 3), device=dev)
    direction = torch.zeros((n, 3), device=dev)
    normal = torch.zeros((n, 3), device=dev)
    uv = torch.zeros((n, 2), device=dev)
    weight = torch.ones(n, device=dev)
    is_shape = torch.zeros(n, dtype=torch.bool, device=dev)
    surf_mat = torch.zeros(n, dtype=torch.long, device=dev)
    valid = torch.full((n,), scene.num_lamps > 0, dtype=torch.bool, device=dev)
    if LAMP_DIRECTIONAL in scene.lamp_types:
        valid &= ltype != LAMP_DIRECTIONAL

    if LAMP_POINT in scene.lamp_types:
        is_pt = ltype == LAMP_POINT
        pt_dir = geom.sample_sphere(u[:, 0], u[:, 1])
        position = torch.where(is_pt[:, None], a["lamp_vec"][lamp_idx], position)
        direction = torch.where(is_pt[:, None], pt_dir, direction)
        normal = torch.where(is_pt[:, None], pt_dir, normal)  # Surface::Color case
        weight = torch.where(is_pt, 4.0 * math.pi, weight)

    if LAMP_SPHERE in scene.lamp_types:
        is_sph = ltype == LAMP_SPHERE
        sref = torch.clamp(ref, max=a["sph_center"].shape[0] - 1)
        s_center = a["sph_center"][sref]
        s_radius = a["sph_radius"][sref]
        point = s_center + geom.sample_sphere(u[:, 0], u[:, 1]) * s_radius[:, None]
        s_normal = geom.normalize(point - s_center)
        if scene.frames:
            _, _, s_uv = geom.sphere_surface_frame(point, s_center, a["sph_texscale"][sref])
            uv = torch.where(is_sph[:, None], s_uv, uv)
        s_dir = geom.sample_hemisphere(u[:, 2], u[:, 3], s_normal)
        position = torch.where(is_sph[:, None], point, position)
        direction = torch.where(is_sph[:, None], s_dir, direction)
        normal = torch.where(is_sph[:, None], s_normal, normal)
        weight = torch.where(is_sph, s_radius * s_radius * 4.0 * math.pi, weight)
        is_shape |= is_sph
        surf_mat = torch.where(is_sph, a["sph_mat"][sref].long(), surf_mat)

    if LAMP_TRIANGLE in scene.lamp_types:
        is_tri = ltype == LAMP_TRIANGLE
        tref = torch.clamp(ref, max=a["tri_v0"].shape[0] - 1)
        tu, tv = u[:, 0], u[:, 1]
        fold = tu + tv > 1.0
        tu = torch.where(fold, 1.0 - tu, tu)
        tv = torch.where(fold, 1.0 - tv, tv)
        t_e1, t_e2 = a["tri_e1"][tref], a["tri_e2"][tref]
        point = a["tri_v0"][tref] + t_e1 * tu[:, None] + t_e2 * tv[:, None]
        tw = 1.0 - tu - tv
        tn = a["tri_n"][tref]
        t_normal = geom.normalize(tn[:, 0] * tw[:, None] + tn[:, 1] * tu[:, None] + tn[:, 2] * tv[:, None])
        if scene.frames:
            tuv = a["tri_uv"][tref]
            t_uv = tuv[:, 0] * tw[:, None] + tuv[:, 1] * tu[:, None] + tuv[:, 2] * tv[:, None]
            uv = torch.where(is_tri[:, None], t_uv, uv)
        t_dir = geom.sample_hemisphere(u[:, 2], u[:, 3], t_normal)
        c = geom.cross(t_e1, t_e2)
        t_area = 0.5 * torch.sqrt(torch.clamp(geom.dot(c, c), min=0.0))
        position = torch.where(is_tri[:, None], point, position)
        direction = torch.where(is_tri[:, None], t_dir, direction)
        normal = torch.where(is_tri[:, None], t_normal, normal)
        weight = torch.where(is_tri, t_area, weight)
        is_shape |= is_tri
        surf_mat = torch.where(is_tri, a["tri_mat"][tref].long(), surf_mat)

    return {
        "lamp_idx": lamp_idx,
        "pick_prob": 1.0 / max(scene.num_lamps, 1),
        "position": position,
        "direction": direction,
        "normal": normal,
        "uv": uv,
        "weight": weight,
        "is_shape": is_shape,
        "surf_mat": surf_mat,
        "color_prog": a["lamp_color"][lamp_idx].long(),
        "valid": valid,
    }


def lamp_start(scene: Scene, wavelengths, draws):
    """The emitter vertex of each lamp path and the state its walk starts
    from (tracer.py:1916-1950): sample_lamp_ray from draws["lamp_idx"] and
    draws["u_lamp"], the emissive component from draws["u_emis"]
    (choose_emissive), its probability program, and the emitter's
    Bounce.probability, weight / (pick probability x material
    probability). The plain version of the CUDA lamp kernel's start mode.
    Returns (vertex, state {origin, direction, alive})."""
    launches["lamp_start"] += 1
    a = scene.arrays
    start = sample_lamp_ray(scene, draws["lamp_idx"], draws["u_lamp"])
    e_comp, e_sel = choose_emissive(scene, start["surf_mat"], draws["u_emis"])
    inputs = ProgramInputs(wavelength=wavelengths, normal=start["normal"], incident=-start["direction"],
                           uv=start["uv"])
    mat_prob = eval_prob_bank(scene, a["comp_prob"][e_comp], inputs, active=start["is_shape"]) * e_sel
    mat_prob = torch.where(start["is_shape"], mat_prob, 1.0)
    origin = start["position"] + start["normal"] * DIST_EPSILON
    vertex = {
        "position": origin,
        "normal": start["normal"],
        "uv": start["uv"],
        "color_prog": torch.where(
            start["is_shape"], a["comp_color"][e_comp].long(), start["color_prog"]).to(torch.int32),
        "probability": start["weight"] / (start["pick_prob"] * torch.clamp(mat_prob, min=1e-20)),
        "is_diffuse": torch.zeros_like(start["valid"]),
        "dispersed": start["is_shape"] & a["comp_prob_uses_wl"][e_comp],
        "valid": start["valid"],
        "brdf": torch.ones_like(start["weight"]),
    }
    return vertex, {"origin": origin, "direction": start["direction"], "alive": start["valid"]}


def lamp_bounce_step(scene: Scene, cfg: TraceConfig, wavelengths, state, draws):
    """One lamp bounce (tracer.py:1953-2034): closest hit, surface data,
    component pick, probability program, scatter, recording the vertex
    instead of brightness (no emission, no NEE). An emissive hit ends the
    path and records nothing, as does a miss. The plain version of the
    CUDA lamp kernel. Returns (new state, vertex with "brdf_scatter", the
    brdf along the scattered direction)."""
    launches["lamp_bounce_step"] += 1
    a = scene.arrays
    alive, o, d = state["alive"], state["origin"], state["direction"]
    hit = intersect_scene(scene, o, d, de_steps=cfg.max_de_steps)
    found = hit["kind"] != KIND_NONE
    normal, mat_id, position, uv = _shading_normal(scene, hit, o, d, wavelengths)
    count = torch.clamp(a["mat_comp_count"][mat_id].long(), min=1)
    pick = torch.minimum((draws["u_comp"] * count).long(), count - 1)
    comp = a["mat_comp_offset"][mat_id].long() + pick
    inputs = ProgramInputs(wavelength=wavelengths, normal=normal, incident=d, uv=uv)
    comp_probability = eval_prob_bank(
        scene, a["comp_prob"][comp], inputs, active=alive & found
    ) * a["comp_selection"][comp]
    sc = scatter(scene, comp, d, normal, wavelengths[:, 0], draws["u_scatter"])
    reflected = alive & found & ~sc["is_emissive"]
    vertex = {
        "position": position,
        "normal": normal,
        "uv": torch.zeros((o.shape[0], 2), device=o.device) if uv is None else uv,
        "color_prog": a["comp_color"][comp].to(torch.int32),
        "probability": sc["probability"] * comp_probability,
        "is_diffuse": sc["is_diffuse"],
        "dispersed": sc["dispersed"] | a["comp_prob_uses_wl"][comp],
        "valid": reflected,
        # after the reference's incident reversal a recorded diffuse vertex
        # weighs 2|n.incident|; a path that ends at the bounce limit keeps
        # its last vertex's scattered direction (brdf_scatter)
        "brdf": brdf_value(normal, d, sc["is_diffuse"]),
        "brdf_scatter": brdf_value(normal, sc["out_dir"], sc["is_diffuse"]),
    }
    return {
        "origin": torch.where(reflected[:, None], position, o),
        "direction": torch.where(reflected[:, None], sc["out_dir"], d),
        "alive": reflected,
    }, vertex


def trace_lamp_path(scene: Scene, cfg: TraceConfig, rng, wavelengths, bank_vals=None):
    """Lamp subpaths with recorded vertices (tracer.py:1904-2090): the
    emitter, then up to cfg.bounces lamp bounces, ending once no path is
    alive; slots past the end stay zero. ``rng`` is an rng.KeyedDraws of
    the wavefront's samples (LAMP_START and LAMP_BOUNCE at each depth), or
    a dict {"start": start draws, "bounces": [draws of each depth]} of given
    draws. Each step goes through kernels_dense.lamp_start / lamp_bounce
    (the plain version on the CPU, the CUDA lamp kernel on a GPU), which
    take ``bank_vals`` (kernels_dense.precompute_bank_values) on a GPU.
    Returns the path dict of [N, L + 1] arrays (see LAMP_VERTEX)."""
    from . import kernels_dense, rng as rng_mod

    n = wavelengths.shape[0]
    dev = wavelengths.device
    keyed = isinstance(rng, KeyedDraws)
    start = rng_mod.lamp_start_draws(rng, n, scene.num_lamps, dev) if keyed else rng["start"]
    vertex, state = kernels_dense.lamp_start(scene, wavelengths, start, bank_vals)
    slots = {k: [vertex[k]] for k in LAMP_VERTEX}
    incident = [state["direction"]]
    last = None
    for i in range(cfg.bounces):
        live = int(state["alive"].sum())
        if live == 0:
            break
        lane_bounces["lamp_live"] += live
        lane_bounces["lamp_executed"] += n
        launches["lamp_bounces"] += 1
        draws = rng_mod.lamp_bounce_draws(rng, n, i, dev) if keyed else rng["bounces"][i]
        incident.append(state["direction"])
        state, vertex = kernels_dense.lamp_bounce(scene, cfg, wavelengths, state, draws, bank_vals)
        for k in LAMP_VERTEX:
            slots[k].append(vertex[k])
        last = i
    path = {}
    for k, dtype in LAMP_VERTEX.items():
        rows = slots[k]
        pad = torch.zeros((n, cfg.bounces + 1 - len(rows)) + rows[0].shape[1:], dtype=dtype, device=dev)
        path[k] = torch.cat([torch.stack(rows, dim=1), pad], dim=1)
    pad = torch.zeros((n, cfg.bounces + 1 - len(incident), 3), device=dev)
    path["incident_out"] = torch.cat([torch.stack(incident, dim=1), pad], dim=1)
    path["brdf_limit"] = (vertex["brdf_scatter"] if last == cfg.bounces - 1
                          else torch.zeros(n, device=dev))
    path["length"] = path["valid"].sum(dim=1).to(torch.int32)
    return path
