"""Vectorized geometric primitives (PyTorch port of pyrite_tpu.geometry).

All functions batch over leading dimensions. Semantics follow the reference
renderer, as the JAX package does:
  - Moller-Trumbore triangle test (shapes/mod.rs:75-119)
  - sphere test (two-root version of shapes/mod.rs:57-74)
  - infinite planes (shapes/mod.rs:441-452)
  - sampling bases ortho/sample_sphere/... (math.rs:98-164)
  - quaternion frames and texture coordinates of sphere, plane and
    distance-estimated hits (shapes/mod.rs:346-372, :454-469), for normal
    maps and textures
"""

from __future__ import annotations

import math

import numpy as np
import torch

DIST_EPSILON = 1e-4


# --- small vector helpers ----------------------------------------------------


def dot(a, b):
    """Sum of the three products in a fixed order, ((x + y) + z): the CUDA
    kernels add in this order too, and a reduction kernel's order would be
    its own (on a ray grazing a large sphere, |l|^2 - tca^2 cancels and one
    ulp decides hit or miss)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# PyTorch's CPU kernels for atan2 and pow run a vectorised routine on whole
# vector widths and libm's on the rest of each thread's range, which round
# differently: an element's result would depend on its place in the batch,
# so a regenerated lane's path could part from the one-shot wavefront's.
# numpy's loops give every element the same routine. On a GPU every element
# takes one device function (the kernels' own libm calls).


def atan2(y, x):
    """torch.atan2, independent of the element's place in the batch."""
    if y.device.type != "cpu":
        return torch.atan2(y, x)
    with np.errstate(all="ignore"):  # inf and nan as PyTorch gives them, silently
        return torch.from_numpy(np.arctan2(y.numpy(), x.numpy()))


def power(x, p):
    """x ** p for a scalar exponent ``p``, independent of the element's
    place in the batch (p is rounded to f32, as PyTorch does)."""
    if x.device.type != "cpu":
        return x**p
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.power(x.numpy(), np.float32(p)))


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def mat3_cols_to_quat(c0, c1, c2):
    """Rotation matrix (columns) -> quaternion (w, x, y, z), matching
    cgmath's From<Matrix3> conversion. On numpy arrays (build_scene's
    per-vertex and per-plane frames, on the host) or torch tensors
    (de_normal_quat)."""
    if isinstance(c0, torch.Tensor):
        sqrt, stack, where = torch.sqrt, torch.stack, torch.where

        def floor0(x):
            return torch.clamp(x, min=0.0)
    else:
        sqrt, stack, where = np.sqrt, np.stack, np.where

        def floor0(x):
            return np.maximum(x, 0.0)

    m00, m01, m02 = c0[..., 0], c0[..., 1], c0[..., 2]
    m10, m11, m12 = c1[..., 0], c1[..., 1], c1[..., 2]
    m20, m21, m22 = c2[..., 0], c2[..., 1], c2[..., 2]
    trace = m00 + m11 + m22

    def build(ww, xx, yy, zz):
        return stack([ww, xx, yy, zz], -1)

    def half_inverse(s):
        return 0.5 / where(s == 0, 1.0, s)

    s0 = sqrt(floor0(trace + 1.0))
    d0 = half_inverse(s0)
    q0 = build(0.5 * s0, (m12 - m21) * d0, (m20 - m02) * d0, (m01 - m10) * d0)

    s1 = sqrt(floor0(1.0 + m00 - m11 - m22))
    d1 = half_inverse(s1)
    q1 = build((m12 - m21) * d1, 0.5 * s1, (m01 + m10) * d1, (m20 + m02) * d1)

    s2 = sqrt(floor0(1.0 + m11 - m00 - m22))
    d2 = half_inverse(s2)
    q2 = build((m20 - m02) * d2, (m01 + m10) * d2, 0.5 * s2, (m12 + m21) * d2)

    s3 = sqrt(floor0(1.0 + m22 - m00 - m11))
    d3 = half_inverse(s3)
    q3 = build((m01 - m10) * d3, (m20 + m02) * d3, (m12 + m21) * d3, 0.5 * s3)

    use0 = trace >= 0.0
    use1 = (~use0) & (m00 > m11) & (m00 > m22)
    use2 = (~use0) & (~((m00 > m11) & (m00 > m22))) & (m11 > m22)
    return where(
        use0[..., None], q0, where(use1[..., None], q1, where(use2[..., None], q2, q3))
    )


# --- quaternion frames (the JAX package's geometry.py:38-125, :259-288) --------


def dot4(a, b):
    """The four products of two quaternions summed in a fixed order,
    (((w + x) + y) + z), as the kernels add them."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2] + a[..., 3] * b[..., 3]


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors [..., 3] by quaternions [..., 4]: v + w t + qv x t,
    t = 2 qv x v."""
    qv = q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v + q[..., 0:1] * t + cross(qv, t)


def quat_normalize(q):
    return q / torch.sqrt(torch.clamp(dot4(q, q), min=1e-20))[..., None]


def axis_angle_quat(axis, angle):
    """Unit-axis rotation quaternion; axis [..., 3], angle [...]."""
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)


def basis(x):
    """(y, z) completing x to a basis (math.rs:119-123)."""
    z = normalize(ortho(x))
    return normalize(cross(z, x)), z


def sphere_surface_frame(position, center, texture_scale):
    """Latitude/longitude uv and the rotation frame of sphere hits
    (shapes/mod.rs:346-372). Returns (normal, quat, uv)."""
    normal = normalize(position - center)
    latitude = torch.acos(torch.clamp(normal[..., 1], -1.0, 1.0))
    longitude = atan2(normal[..., 0], normal[..., 2])
    ey = torch.tensor([0.0, 1.0, 0.0], device=normal.device).expand(normal.shape)
    ex = torch.tensor([1.0, 0.0, 0.0], device=normal.device).expand(normal.shape)
    quat = quat_mul(axis_angle_quat(ey, longitude), axis_angle_quat(ex, latitude - math.pi * 0.5))
    # divided by tensors: PyTorch on CUDA divides by a Python number as a
    # product with its reciprocal, one ulp off the quotient the kernels (and
    # the CPU) take, which a large normal map turns into ~1e-4 in the normal
    u = longitude / torch.full_like(longitude, 2.0 * math.pi)
    v = 1.0 - latitude / torch.full_like(latitude, math.pi)
    return normal, quat, torch.stack([u, v], dim=-1) / texture_scale


def plane_uv(position, quat, texture_scale):
    """Texture coordinates on an infinite plane: the position rotated into
    the plane's tangent space (shapes/mod.rs:454-469)."""
    return quat_rotate(quat_conj(quat), position)[..., :2] / texture_scale


def de_normal_quat(normal):
    """The frame of a distance-estimated hit (Normal::from_vector)."""
    y, z = basis(normal)
    return mat3_cols_to_quat(y, z, normal)


# --- sampling bases (math.rs:98-164) ------------------------------------------


def ortho(v):
    """The reference's 'ortho': v x unit, with the unit picked per component."""
    ax = torch.abs(v[..., 0]) < DIST_EPSILON
    ay = torch.abs(v[..., 1]) < DIST_EPSILON
    az = torch.abs(v[..., 2]) < DIST_EPSILON
    zero = torch.zeros_like(v[..., 0])
    one = torch.ones_like(zero)
    ux = torch.where(ax, one, torch.where(ay, zero, torch.where(az, zero, -v[..., 1])))
    uy = torch.where(ax, zero, torch.where(ay, one, torch.where(az, zero, v[..., 0])))
    uz = torch.where(ax, zero, torch.where(ay, zero, torch.where(az, one, zero)))
    return cross(v, torch.stack([ux, uy, uz], dim=-1))


def sample_sphere(u, v):
    """Uniform direction from two uniforms (math.rs:147-153)."""
    theta = 2.0 * math.pi * u
    phi = torch.arccos(torch.clamp(2.0 * v - 1.0, -1.0, 1.0))
    sin_phi = torch.sin(phi)
    return torch.stack(
        [sin_phi * torch.cos(theta), sin_phi * torch.sin(theta), torch.cos(phi)], dim=-1
    )


def sample_hemisphere(u, v, direction):
    """Uniform hemisphere around ``direction`` (math.rs:155-164)."""
    s = sample_sphere(u, v)
    o = normalize(ortho(direction))
    x = o * s[..., 0:1]
    y = normalize(cross(o, direction)) * s[..., 1:2]
    z = normalize(direction) * torch.abs(s[..., 2:3])
    return x + y + z


def sample_cone(u1, u2, direction, cos_half):
    """Cone sampling (math.rs:125-137)."""
    o1 = normalize(ortho(direction))
    o2 = normalize(cross(direction, o1))
    r1 = 2.0 * math.pi * u1
    r2 = cos_half + (1.0 - cos_half) * u2
    oneminus = torch.sqrt(torch.clamp(1.0 - r2 * r2, min=0.0))
    return (
        o1 * (torch.cos(r1) * oneminus)[..., None]
        + o2 * (torch.sin(r1) * oneminus)[..., None]
        + direction * r2[..., None]
    )


def solid_angle(cos_half):
    return torch.where(cos_half >= 1.0, 0.0, 2.0 * math.pi * (1.0 - cos_half))


# --- intersections -------------------------------------------------------------


def ray_triangle(origin, direction, v0, e1, e2):
    """Moller-Trumbore, batched over broadcastable leading dims.

    Returns (hit, t, u, v)."""
    p = cross(direction, e2)
    det = dot(e1, p)
    ok = torch.abs(det) > DIST_EPSILON
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = origin - v0
    u = dot(tvec, p) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    q = cross(tvec, e1)
    v = dot(direction, q) * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = dot(e2, q) * inv_det
    ok = ok & (t > DIST_EPSILON)
    return ok, torch.where(ok, t, math.inf), u, v


def ray_sphere(origin, direction, center, radius):
    """Nearest positive-root sphere hit. Returns (hit, t)."""
    l = center - origin
    tca = dot(l, direction)
    d2 = dot(l, l) - tca * tca
    r2 = radius * radius
    ok = d2 <= r2
    thc = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    t0 = tca - thc
    t1 = tca + thc
    t = torch.where(t0 > DIST_EPSILON, t0, t1)
    ok = ok & (t > DIST_EPSILON)
    return ok, torch.where(ok, t, math.inf)


def ray_plane(origin, direction, normal, d):
    """Infinite plane n.x = d. Returns (hit, t)."""
    denom = dot(normal, direction)
    ok = torch.abs(denom) > 1e-12
    t = (d - dot(normal, origin)) / torch.where(ok, denom, 1.0)
    ok = ok & (t > DIST_EPSILON)
    return ok, torch.where(ok, t, math.inf)


def ray_aabb_range(origin, direction, lo, hi):
    """Box slab test (hit, tmin, tmax) with tmin clamped to 0 (BoundingVolume
    ::Box, shapes/mod.rs:594-667). NaN from 0 * inf propagates through the
    min/max, as in the JAX package, and misses."""
    inv = 1.0 / direction
    t1 = (lo - origin) * inv
    t2 = (hi - origin) * inv
    tmin = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=0.0)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    return tmin < tmax, tmin, tmax


def ray_sphere_range(origin, direction, center, radius):
    """Bounding-sphere (hit, entry, exit) like BoundingVolume::Sphere,
    including its tca >= 0 requirement (shapes/mod.rs:668-680)."""
    l = center - origin
    tca = dot(l, direction)
    d2 = dot(l, l) - tca * tca
    r2 = radius * radius
    ok = (tca >= 0.0) & (d2 <= r2)
    thc = torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    return ok, torch.clamp(tca - thc, min=0.0), tca + thc
