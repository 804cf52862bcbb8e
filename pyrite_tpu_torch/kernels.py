"""Ray queries on the GPU: the wrappers of the CUDA traversal kernels of
csrc/wide_bvh.cu (the counterpart of pyrite_tpu.kernels' walk, fetch and
sweep kernels) and of the DE march kernel of csrc/march_de.cu (its
counterpart of pyrite_tpu.kernels.march_de).

- ``closest_wide(scene, origin, direction, init)``: the closest hit over the
  planes and the clustered wide BVH, from a running hit ``init``;
  wide_closest_kernel.
- ``shadow_wide(scene, origin, direction, max_dist, block_below)``: the
  nearest occluder from the lamp distance, stopping below the occlusion
  bound; wide_shadow_kernel (``launch_shadow_wide`` launches it on a mesh
  scene with DE shapes too, for kernels_dense.shadow_query, which adds the
  shapes' t).
- ``march_de(est, local_origin, direction, t0, tmax, hit, max_steps,
  omega)``: the sphere-traced march of one DE shape; march_de_kernel, the
  persistent pass that the bounce runs over its rays
  (kernels_dense.march_pass), here over the given rays.

Each takes its plain version (tracer.intersect_scene / intersect_shadow,
tracer.march_de_plain) for tensors on the CPU and launches its kernel for
tensors on a GPU, or raises.
The simple renderer's bounce walks the tree inside its own kernels
(kernels_dense.bounce_dense); these are the queries on their own, for
callers that trace rays without shading them.
"""

from __future__ import annotations

import ctypes

import torch

from . import tracer
from .kernels_dense import DE_FIELDS, _check, _flag, check_leaves, check_rays, estimator_fields

# Each wrapper adds one here where it launches its kernel.
launches = {"wide_closest_kernel": 0, "wide_shadow_kernel": 0, "march_de_kernel": 0}


def _route(scene, origin):
    dev = origin.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the wide-BVH queries run on CPU or CUDA tensors, not {dev}")
    if not scene.use_clusters:
        raise ValueError("the wide-BVH queries take a mesh scene (scene.use_clusters)")
    if scene.de_shapes:
        raise ValueError("the wide-BVH queries trace the tree alone, not a scene with DE shapes")
    return dev


def _ray_args(scene, origin, direction, dev):
    """sheet, meta, node table, leaf clusters, leaf size, rays."""
    f32, i32 = torch.float32, torch.int32
    n = origin.shape[0]
    pack = scene.dense_pack["tensors"]
    a = scene.arrays
    return [
        _check("sheet", pack["sheet"], f32, pack["sheet"].shape, dev),
        _check("meta", pack["meta"], i32, pack["meta"].shape, dev),
        _check("wide_rows", a["wide_rows"], f32, (273, 128), dev),
        check_leaves(scene, dev),
        scene.cluster_leaf,
        _check("origin", origin, f32, (n, 3), dev),
        _check("direction", direction, f32, (n, 3), dev),
    ]


def closest_wide(scene, origin, direction, init=None):
    """Closest hit of each ray from the running hit ``init``
    (tracer.empty_hit by default): {t, kind, idx, u, v}, idx int64 as in
    tracer.intersect_scene."""
    dev = _route(scene, origin)
    n = origin.shape[0]
    init = tracer.empty_hit(n, dev) if init is None else init
    if dev.type == "cpu":
        return tracer.intersect_scene(scene, origin, direction, init)
    from . import _build

    f32, i32 = torch.float32, torch.int32
    dtypes = {"t": f32, "kind": i32, "idx": i32, "u": f32, "v": f32}
    ins = {k: init[k].to(dt).contiguous() for k, dt in dtypes.items()}
    out = {k: torch.empty_like(v) for k, v in ins.items()}
    args = _ray_args(scene, origin, direction, dev)
    args += [_check(k, ins[k], dt, (n,), dev) for k, dt in dtypes.items()]
    args += [out[k].data_ptr() for k in dtypes]
    args += [n, torch.cuda.current_stream(dev).cuda_stream]
    rc = _build.load().pyrite_wide_closest(*args)
    if rc != 0:
        raise RuntimeError(f"wide_closest_kernel launch failed: cudaError {rc}")
    launches["wide_closest_kernel"] += 1
    out["idx"] = out["idx"].long()
    return out


def shadow_wide(scene, origin, direction, max_dist, block_below):
    """Nearest occluder of each shadow ray, from ``max_dist``; a ray stops
    at the first leaf that leaves its t below ``block_below`` (then its t is
    some blocker's). Returns t [N]."""
    dev = _route(scene, origin)
    if dev.type == "cpu":
        return tracer.intersect_shadow(scene, origin, direction, max_dist, block_below)
    return launch_shadow_wide(scene, origin, direction, max_dist, block_below)


def launch_shadow_wide(scene, origin, direction, max_dist, block_below):
    """One wide_shadow_kernel launch on CUDA tensors: the planes and the
    tree of a mesh scene, without its DE shapes (which
    kernels_dense.shadow_query adds from a march pass)."""
    from . import _build

    dev = origin.device
    n = origin.shape[0]
    f32 = torch.float32
    t = torch.empty(n, dtype=f32, device=dev)
    args = _ray_args(scene, origin, direction, dev) + [
        _check("max_dist", max_dist, f32, (n,), dev),
        _check("block_below", block_below, f32, (n,), dev),
        t.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    ]
    rc = _build.load().pyrite_wide_shadow(*args)
    if rc != 0:
        raise RuntimeError(f"wide_shadow_kernel launch failed: cudaError {rc}")
    launches["wide_shadow_kernel"] += 1
    return t


def march_de(est, local_origin, direction, t0, tmax, hit, max_steps, omega=tracer.DE_OMEGA):
    """The sphere-traced march of the DE shape whose estimator is ``est``
    (scene.DEShape.estimator), in its local space: ``local_origin`` and
    ``direction`` [N, 3], t0 / tmax [N], hit [N] bool (lanes that missed the
    bounds do not march). Returns (total, dist) [N], as
    tracer.march_de_plain."""
    dev = local_origin.device
    check_rays(local_origin.shape[0], "march_de")
    if dev.type == "cpu":
        return tracer.march_de_plain(est, local_origin, direction, t0, tmax, hit, max_steps, omega)
    if dev.type != "cuda":
        raise ValueError(f"march_de runs on CPU or CUDA tensors, not {dev}")
    from . import _build

    n = local_origin.shape[0]
    f32 = torch.float32
    # the march reads the estimator's fields only; the bounds' stay 0
    values = estimator_fields(est).tolist()
    fields = (ctypes.c_float * len(DE_FIELDS))(*values)
    total = torch.empty(n, dtype=f32, device=dev)
    dist = torch.empty(n, dtype=f32, device=dev)
    # the pass's 64-bit work counter; the launcher zeroes it on the stream
    next_item = torch.empty(1, dtype=torch.int64, device=dev)
    rc = _build.load().pyrite_march_de(
        ctypes.addressof(fields),
        _check("local_origin", local_origin, f32, (n, 3), dev),
        _check("direction", direction, f32, (n, 3), dev),
        _check("t0", t0, f32, (n,), dev),
        _check("tmax", tmax, f32, (n,), dev),
        _check("hit", _flag(hit), torch.uint8, (n,), dev),
        max_steps, omega, total.data_ptr(), dist.data_ptr(), n, next_item.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"march_de_kernel launch failed: cudaError {rc}")
    launches["march_de_kernel"] += 1
    return total, dist
