"""Scene building: typed IR -> flat device tensors + compiled programs
(PyTorch port of pyrite_tpu.scene, dense scenes).

Triangles, spheres and planes become structure-of-arrays tensors on the
scene's device; materials become a flattened global component table
(materials/mod.rs:89-228 semantics, including synthesized Mix probability
expressions and uniform selection compensation). The arrays are built in
numpy exactly as the JAX package builds them and moved to the device once.

Scenes of more than CLUSTER_THRESHOLD finite primitives (meshes, and any
scene above the dense kernels' 128) take the clustered wide BVH: the
binary SAH build orders the
primitives, its treelets become leaf clusters of up to ``cluster_leaf``
primitives packed into ``clu_geo`` [slots, leaf, 12], and bvh.build_wide_bvh
puts the 16-ary node table ``wide_rows`` [273, 128] over them. Distance-
estimated shapes (``RayMarched``) become ``scene.de_shapes``, marched
outside the primitives as in the JAX package. kernels_dense.build_pack,
called at the end of build_scene, refuses the rest of what the CUDA kernels
do not take. Image textures are loaded into the Resources store
(``scene.resources``) and read by the programs as tensors.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import bvh as bvh_mod
from . import exprs
from . import geometry as geom
from . import native
from .project import ir

# bsdf type codes
BSDF_EMISSIVE = 0
BSDF_DIFFUSE = 1
BSDF_MIRROR = 2
BSDF_REFRACTIVE = 3

# lamp type codes
LAMP_DIRECTIONAL = 0
LAMP_POINT = 1
LAMP_SPHERE = 2
LAMP_TRIANGLE = 3

# primitive kinds
PRIM_TRIANGLE = 0
PRIM_SPHERE = 1

# Above this many primitives the scene takes the clustered wide BVH: the
# dense kernels sweep at most 128 (one sheet row). The JAX package sweeps
# scenes of up to 1024 brute force in XLA (its tracer.py:350-353); here
# those take the wide kernels, 2 to 8 leaves of CLUSTER_LEAF.
CLUSTER_THRESHOLD = 128
# Primitives per leaf cluster (one [CLUSTER_LEAF, 12] block of clu_geo),
# grown in steps of 128 when the leaves would not fit the wide tree.
CLUSTER_LEAF = 128


def cluster_leaf_size(total_prims: int) -> int:
    """CLUSTER_LEAF, grown in steps of 128 for scenes whose leaf count would
    exceed the wide tree's 4096 slots (scene.py:55-63 of the JAX package)."""
    capacity = bvh_mod.WIDE_FANOUT**bvh_mod.WIDE_LEVELS
    needed = -(-total_prims // capacity)
    return max(CLUSTER_LEAF, -(-needed // 128) * 128)


def pack_wide_clusters_ranges(perm_lo, perm_hi, geo_rows, ranges, leaf_size):
    """Pack explicit (start, count) ranges of the primitive permutation (the
    SAH treelet cut) into fixed-capacity clusters and build the wide 16-ary
    tree over their tight bounds. Partly filled clusters pad with kind = -1
    rows, which never intersect. Returns (rows [273, 128] f32, geo [slots,
    leaf_size, 12] f32), geo indexed by leaf slot."""
    num_leaves = len(ranges)
    geo_p = np.zeros((num_leaves, leaf_size, 12), np.float32)
    geo_p[..., 10] = -1.0
    leaf_lo = np.full((num_leaves, 3), np.inf, np.float32)
    leaf_hi = np.full((num_leaves, 3), -np.inf, np.float32)
    for j, (start, count) in enumerate(ranges):
        geo_p[j, :count] = geo_rows[start : start + count]
        leaf_lo[j] = perm_lo[start : start + count].min(axis=0)
        leaf_hi[j] = perm_hi[start : start + count].max(axis=0)
    rows, slot_of_leaf = bvh_mod.build_wide_bvh(leaf_lo, leaf_hi)

    slots = int(slot_of_leaf.max()) + 1
    geo = np.zeros((slots, leaf_size, 12), np.float32)
    geo[..., 10] = -1.0
    geo[slot_of_leaf] = geo_p
    return rows, geo


def pack_wide_clusters(perm_lo, perm_hi, geo_rows, leaf_size):
    """Chunk the SAH depth-first order into full ``leaf_size`` clusters (the
    last one padded with kind = -1 rows) and build the wide tree over them.
    Returns (rows [273, 128] f32, geo [slots, leaf_size, 12] f32)."""
    total = len(geo_rows)
    num_leaves = -(-total // leaf_size)
    padded = num_leaves * leaf_size
    geo_p = np.zeros((padded, 12), np.float32)
    geo_p[..., 10] = -1.0
    geo_p[:total] = geo_rows
    lo_p = np.full((padded, 3), np.inf, np.float32)
    hi_p = np.full((padded, 3), -np.inf, np.float32)
    lo_p[:total] = perm_lo
    hi_p[:total] = perm_hi

    leaf_lo = lo_p.reshape(num_leaves, leaf_size, 3).min(axis=1)
    leaf_hi = hi_p.reshape(num_leaves, leaf_size, 3).max(axis=1)
    rows, slot_of_leaf = bvh_mod.build_wide_bvh(leaf_lo, leaf_hi)

    slots = int(slot_of_leaf.max()) + 1
    geo = np.zeros((slots, leaf_size, 12), np.float32)
    geo[..., 10] = -1.0
    geo[slot_of_leaf] = geo_p.reshape(num_leaves, leaf_size, 12)
    return rows, geo


def _mul_expr(lhs, rhs):
    if isinstance(lhs, float) and isinstance(rhs, float):
        return lhs * rhs
    return ir.ComplexExpression("binary", {"operator": "mul", "lhs": lhs, "rhs": rhs})


def _sub_expr(lhs, rhs):
    if isinstance(lhs, float) and isinstance(rhs, float):
        return lhs - rhs
    return ir.ComplexExpression("binary", {"operator": "sub", "lhs": lhs, "rhs": rhs})


def _clamp_expr(value, lo, hi):
    if isinstance(value, float):
        return min(max(value, lo), hi)
    return ir.ComplexExpression("clamp", {"value": value, "min": lo, "max": hi})


@dataclass
class FlatComponent:
    bsdf_type: int
    color: ir.Expression
    probability: Optional[ir.Expression]
    ior: float = 0.0
    env_ior: float = 1.0
    dispersion: float = 0.0
    env_dispersion: float = 0.0


def flatten_material(node: ir.MaterialNode) -> list[FlatComponent]:
    """Material tree -> component list (materials/mod.rs:96-211).

    Mix(lhs, rhs, amount): lhs gets P*clamp(amount); rhs gets 1 - P*clamp(amount).
    Stack order matches the reference (rhs subtree emitted first)."""
    stack = [(node, None)]
    components: list[FlatComponent] = []
    while stack:
        mat, probability = stack.pop()
        kind = mat.kind
        f = mat.fields
        if kind in ("emissive", "diffuse", "mirror"):
            bsdf = {"emissive": BSDF_EMISSIVE, "diffuse": BSDF_DIFFUSE, "mirror": BSDF_MIRROR}[kind]
            components.append(
                FlatComponent(bsdf_type=bsdf, color=f["color"], probability=probability)
            )
        elif kind == "refractive":
            def const(e, default):
                return default if e is None else ir.eval_number(e)

            components.append(
                FlatComponent(
                    bsdf_type=BSDF_REFRACTIVE,
                    color=f["color"],
                    probability=probability,
                    ior=ir.eval_number(f["ior"]),
                    env_ior=const(f.get("env_ior"), 1.0),
                    dispersion=const(f.get("dispersion"), 0.0),
                    env_dispersion=const(f.get("env_dispersion"), 0.0),
                )
            )
        elif kind == "mix":
            amount = _clamp_expr(f["amount"], 0.0, 1.0)
            lhs_probability = (
                amount if probability is None else _mul_expr(probability, amount)
            )
            stack.append((f["lhs"], lhs_probability))
            stack.append((f["rhs"], _sub_expr(1.0, lhs_probability)))
        elif kind == "binary":
            stack.append((f["lhs"], probability))
            stack.append((f["rhs"], probability))
        else:
            raise ir.ProjectError(f"unknown material node {kind!r}")
    return components


@dataclass
class DEShape:
    """A distance-estimated (ray-marched) shape: its estimator's parameters
    (the JAX package's dict), its bounding volume and its material."""

    estimator: dict
    bounds_kind: str  # "box" | "sphere"
    bounds_a: np.ndarray  # box min / sphere center, f32 [3]
    bounds_b: np.ndarray  # box max / [radius, 0, 0], f32 [3]
    material_id: int

    @property
    def center(self) -> np.ndarray:
        """The origin of the shape's local space: the box center, in f32 as
        the JAX package computes it, or the sphere center."""
        if self.bounds_kind == "box":
            return (self.bounds_a + self.bounds_b) * np.float32(0.5)
        return self.bounds_a


class Scene:
    """Scene container: device tensors + compiled program banks."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.arrays: dict = {}
        self.color_programs: list[exprs.CompiledProgram] = []
        self.prob_programs: list[exprs.CompiledProgram] = []
        self.normal_programs: list[exprs.CompiledProgram] = []
        self.de_shapes: list[DEShape] = []
        self.directional_lamps: list = []
        self.sky_program: Optional[exprs.CompiledProgram] = None
        self.num_lamps = 0
        self.lamp_types = set()
        self.num_planes = 0
        self.num_triangles = 0
        self.num_spheres = 0
        # bank-table state (bake_bank_tables): per-program bakeable flags, or
        # None when the bank is small enough for the exact per-program loop
        self.color_bank_bakeable = None
        self.prob_bank_bakeable = None
        self.bank_span = (380.0, 780.0)
        # the project's spectral columns, which the kernels' gate checks,
        # and on a photon-mapping project its chain mode and the wider rows
        # its renderer launches (photon_widths: {"exact", "camera", "lamp",
        # "bins"}), which the gate checks too and the renderer reads
        self.spectrum_samples = 1
        self.photon_widths = None
        # the CUDA bounce kernels' scene pack (kernels_dense.build_pack)
        self.dense_pack = None
        self.resources = None
        # whether a program reads the hit's uv or a material maps normals:
        # then the plain version computes each hit's frame and uv
        # (tracer.surface_data with frames)
        self.frames = False
        # the clustered wide BVH (scenes above CLUSTER_THRESHOLD primitives)
        self.use_clusters = False
        self.cluster_leaf = 0
        self.cluster_slots = 0

    @property
    def num_primitives(self):
        return self.num_triangles + self.num_spheres

    @property
    def texture_bytes(self):
        """Bytes of the image textures the scene keeps on its device."""
        return sum(t.nbytes for t in self.resources.store.values()) if self.resources else 0


def _look_at_matrix(look: ir.LookAt) -> np.ndarray:
    """Inverted cgmath look_at: camera/object -> world (project/mod.rs:254-269)."""
    eye = ir.eval_vector3(look.from_)
    center = ir.eval_vector3(look.to)
    up = ir.eval_vector3(look.up) if look.up is not None else np.array([0.0, 1.0, 0.0])
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = s
    m[:3, 1] = u
    m[:3, 2] = -f
    m[:3, 3] = eye
    return m


def _transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:3, :3].T + m[:3, 3]


def _transform_vectors(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    return vecs @ m[:3, :3].T


def require_device(device, what):
    """``device`` as a torch.device; a CUDA device without one raises, and
    says to pass device="cpu": nothing moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {dev}, but torch finds no CUDA device; pass device=\"cpu\" "
            "to work on the CPU"
        )
    return dev


# the JAX package's budget of the photon renderer's [N, bounces, S + G]
# camera record (photon.py:568-575)
PHOTON_GRID_BUDGET = 400_000_000


def exact_chain_mode(scene: Scene) -> bool:
    """True when every color program reads only the wavelength: the photon
    renderer then re-walks chains exactly at any wavelength.
    PYRITE_TPU_PHOTON_EXACT=0 forces the grid interpolation. build_scene
    decides it once, into scene.photon_widths."""
    if os.environ.get("PYRITE_TPU_PHOTON_EXACT", "1") == "0":
        return False
    return all(not p.uses_ray_inputs for p in scene.color_programs)


def grid_bins(width, height, bounces, spectrum_samples, spectrum_bins, exact):
    """G, the wavelength grid the photon renderer's camera walk traces
    beside its S film columns in interpolation mode (0 in exact mode):
    spectrum_bins, halved while the whole film's [N, bounces, S + G] record
    passes PHOTON_GRID_BUDGET values, as the JAX package sizes it
    (photon.py:568-575)."""
    g = 0 if exact else spectrum_bins
    while g > 8 and width * height * max(bounces, 1) * (spectrum_samples + g) > PHOTON_GRID_BUDGET:
        g //= 2
    return g


def photon_widths(project, exact) -> dict:
    """A photon-mapping project's chain mode and the spectral columns its
    renderer's kernels launch at: {"exact", "camera": S + G, "lamp": 1 in
    exact mode, else 1 + the film's bins, "bins": the film's bins}. The gate
    (kernels_dense.build_pack) checks them; renderers.photon reads them."""
    r, im = project.renderer, project.image
    g = grid_bins(im.width, im.height, r.bounces, r.spectrum_samples, r.spectrum_bins, exact)
    return {"exact": exact, "camera": r.spectrum_samples + g,
            "lamp": 1 if exact else 1 + r.spectrum_bins, "bins": r.spectrum_bins}


def build_scene(project_data, device="cuda") -> Scene:
    """Build the scene's tables on ``device``, the card unless the caller
    asks for the CPU (device="cpu"); a CUDA device without one raises.
    Every scene the JAX package builds is taken (kernels_dense.build_pack)."""
    project = project_data.project
    resources = exprs.Resources(texture_loader=project_data.textures)
    scene = Scene(require_device(device, "build_scene"))
    scene.resources = resources

    # --- program banks with dedup -------------------------------------------
    color_prog_ids: dict = {}
    prob_prog_ids: dict = {}
    normal_prog_ids: dict = {}

    def add_color_program(expr) -> int:
        key = id(expr) if isinstance(expr, ir.ComplexExpression) else ("const", expr)
        if key not in color_prog_ids:
            color_prog_ids[key] = len(scene.color_programs)
            scene.color_programs.append(exprs.compile_program(expr, resources, exprs.NUMBER))
        return color_prog_ids[key]

    def add_prob_program(expr) -> int:
        if expr is None:
            return -1
        key = id(expr) if isinstance(expr, ir.ComplexExpression) else ("const", expr)
        if key not in prob_prog_ids:
            prob_prog_ids[key] = len(scene.prob_programs)
            scene.prob_programs.append(exprs.compile_program(expr, resources, exprs.NUMBER))
        return prob_prog_ids[key]

    def add_normal_program(expr) -> int:
        if expr is None:
            return -1
        key = id(expr)
        if key not in normal_prog_ids:
            normal_prog_ids[key] = len(scene.normal_programs)
            scene.normal_programs.append(exprs.compile_program(expr, resources, exprs.VECTOR))
        return normal_prog_ids[key]

    # --- material table ------------------------------------------------------
    material_ids: dict = {}
    mat_comp_offset: list[int] = []
    mat_comp_count: list[int] = []
    mat_emis_offset: list[int] = []
    mat_emis_count: list[int] = []
    mat_normal_prog: list[int] = []

    comp_bsdf: list[int] = []
    comp_color: list[int] = []
    comp_prob: list[int] = []
    comp_color_uses_wl: list[bool] = []
    comp_prob_uses_wl: list[bool] = []
    comp_selection: list[float] = []
    comp_ior: list[float] = []
    comp_env_ior: list[float] = []
    comp_disp: list[float] = []
    comp_env_disp: list[float] = []

    emis_comp: list[int] = []
    emis_selection: list[float] = []

    def add_material(material: ir.Material) -> int:
        key = id(material.surface), id(material.normal_map)
        if key in material_ids:
            return material_ids[key]
        mid = len(mat_comp_offset)
        material_ids[key] = mid

        flat = flatten_material(material.surface)
        mat_comp_offset.append(len(comp_bsdf))
        mat_comp_count.append(len(flat))
        mat_normal_prog.append(add_normal_program(material.normal_map))

        emissive_indices = []
        for comp in flat:
            idx = len(comp_bsdf)
            comp_bsdf.append(comp.bsdf_type)
            cp = add_color_program(comp.color)
            comp_color.append(cp)
            comp_color_uses_wl.append(scene.color_programs[cp].uses_wavelength)
            pp = add_prob_program(comp.probability)
            comp_prob.append(pp)
            comp_prob_uses_wl.append(pp >= 0 and scene.prob_programs[pp].uses_wavelength)
            comp_selection.append(float(len(flat)))
            comp_ior.append(comp.ior)
            comp_env_ior.append(comp.env_ior)
            comp_disp.append(comp.dispersion)
            comp_env_disp.append(comp.env_dispersion)
            if comp.bsdf_type == BSDF_EMISSIVE:
                emissive_indices.append(idx)

        mat_emis_offset.append(len(emis_comp))
        mat_emis_count.append(len(emissive_indices))
        for idx in emissive_indices:
            emis_comp.append(idx)
            emis_selection.append(float(len(emissive_indices)))
        return mid

    def material_is_emissive(mid: int) -> bool:
        return mat_emis_count[mid] > 0

    # --- geometry ------------------------------------------------------------
    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n, tri_q, tri_uv, tri_mat = [], [], [], []
    sph_center, sph_radius, sph_texscale, sph_mat = [], [], [], []
    pla_normal, pla_d, pla_quat, pla_texscale, pla_mat = [], [], [], [], []

    lamp_type, lamp_ref, lamp_vec, lamp_width, lamp_color = [], [], [], [], []

    def texscale_of(e) -> np.ndarray:
        if e is None:
            return np.array([1.0, 1.0], np.float32)
        v = ir.eval_vector4(e)
        return np.array([v[0], v[1]], np.float32)

    def np_basis(v):
        # the reference's ortho/basis in numpy, for host-side plane frames
        if abs(v[0]) < geom.DIST_EPSILON:
            unit = np.array([1.0, 0.0, 0.0])
        elif abs(v[1]) < geom.DIST_EPSILON:
            unit = np.array([0.0, 1.0, 0.0])
        elif abs(v[2]) < geom.DIST_EPSILON:
            unit = np.array([0.0, 0.0, 1.0])
        else:
            unit = np.array([-v[1], v[0], 0.0])
        z = np.cross(v, unit)
        z = z / np.linalg.norm(z)
        y = np.cross(z, v)
        y = y / np.linalg.norm(y)
        return y, z

    def add_mesh_triangles(obj_mesh, faces_v, faces_vt, faces_vn, mid, scale, transform):
        positions = obj_mesh.positions
        normals_pool = obj_mesh.normals
        uv_pool = obj_mesh.texcoords

        v = positions[faces_v]  # [T, 3, 3]
        has_n = np.all(faces_vn >= 0, axis=1)
        n = np.where(
            has_n[:, None, None],
            normals_pool[np.maximum(faces_vn, 0)] if len(normals_pool) else np.zeros_like(v),
            0.0,
        )
        # face normals where vertex normals are missing
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        face_n = np.cross(e1, e2)
        face_n /= np.maximum(np.linalg.norm(face_n, axis=1, keepdims=True), 1e-20)
        n = np.where(has_n[:, None, None], n, face_n[:, None, :])

        has_t = faces_vt >= 0
        uv = np.where(
            has_t[:, :, None],
            uv_pool[np.maximum(faces_vt, 0)] if len(uv_pool) else np.zeros((1, 2)),
            0.0,
        )

        # tangent frame from UV deltas (world.rs:344-352)
        dt1 = uv[:, 1] - uv[:, 0]
        dt2 = uv[:, 2] - uv[:, 0]
        denom = dt1[:, 0] * dt2[:, 1] - dt1[:, 1] * dt2[:, 0]
        r = 1.0 / np.where(np.abs(denom) < 1e-30, np.inf, denom)
        tangent = (e1 * dt2[:, 1:2] - e2 * dt1[:, 1:2]) * r[:, None]
        bitangent = (e2 * dt1[:, 0:1] - e1 * dt2[:, 0:1]) * r[:, None]

        # scale then transform (world.rs:221-223)
        v = v * scale
        if transform is not None:
            v = _transform_points(transform, v.reshape(-1, 3)).reshape(v.shape)
            n_flat = _transform_vectors(transform, n.reshape(-1, 3))
            n_flat /= np.maximum(np.linalg.norm(n_flat, axis=1, keepdims=True), 1e-20)
            n = n_flat.reshape(n.shape)
            tangent = _transform_vectors(transform, tangent)
            bitangent = _transform_vectors(transform, bitangent)

        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]

        # per-vertex frame quaternion: Matrix3(tangent, bitangent, n_vertex)
        quats = geom.mat3_cols_to_quat(
            np.repeat(tangent[:, None, :], 3, axis=1).reshape(-1, 3),
            np.repeat(bitangent[:, None, :], 3, axis=1).reshape(-1, 3),
            n.reshape(-1, 3),
        ).reshape(-1, 3, 4)

        start = len(tri_v0)
        for i in range(len(v)):
            tri_v0.append(v[i, 0])
            tri_e1.append(e1[i])
            tri_e2.append(e2[i])
            tri_n.append(n[i])
            tri_q.append(quats[i])
            tri_uv.append(uv[i])
            tri_mat.append(mid)
        return start, len(v)

    for obj in project.world.objects:
        if isinstance(obj, ir.Sphere):
            mid = add_material(obj.material)
            idx = len(sph_center)
            sph_center.append(ir.eval_vector3(obj.position))
            sph_radius.append(ir.eval_number(obj.radius))
            sph_texscale.append(texscale_of(obj.texture_scale))
            sph_mat.append(mid)
            if material_is_emissive(mid):
                lamp_type.append(LAMP_SPHERE)
                lamp_ref.append(idx)
                lamp_vec.append(np.zeros(3, np.float32))
                lamp_width.append(0.0)
                lamp_color.append(-1)
        elif isinstance(obj, ir.Plane):
            mid = add_material(obj.material)
            normal = ir.eval_vector3(obj.normal)
            normal = normal / np.linalg.norm(normal)
            origin = ir.eval_vector3(obj.origin)
            binormal, tangent = np_basis(normal)
            quat = geom.mat3_cols_to_quat(binormal[None], tangent[None], normal[None])[0]
            pla_normal.append(normal)
            # the reference's plane test solves n.x + d = 0 with d = n.origin,
            # so every plane is mirrored through the world origin; the JAX
            # package reproduces that and so does the port (scene.py:537-543)
            pla_d.append(float(-np.dot(normal, origin)))
            pla_quat.append(quat)
            pla_texscale.append(texscale_of(obj.texture_scale))
            pla_mat.append(mid)
            if material_is_emissive(mid):
                print("Warning: emissive planes may not always produce correct results.")
        elif isinstance(obj, ir.Mesh):
            obj_mesh = project_data.meshes.load(obj.file)
            scale = 1.0 if obj.scale is None else ir.eval_number(obj.scale)
            transform = None if obj.transform is None else _look_at_matrix(obj.transform)
            for mesh_obj in obj_mesh.objects:
                if mesh_obj.name not in obj.materials:
                    raise ir.ProjectError(f"missing material for '{mesh_obj.name}'")
                mid = add_material(obj.materials[mesh_obj.name])
                start, count = add_mesh_triangles(
                    obj_mesh, mesh_obj.faces_v, mesh_obj.faces_vt, mesh_obj.faces_vn,
                    mid, scale, transform,
                )
                if material_is_emissive(mid):
                    for t in range(start, start + count):
                        lamp_type.append(LAMP_TRIANGLE)
                        lamp_ref.append(t)
                        lamp_vec.append(np.zeros(3, np.float32))
                        lamp_width.append(0.0)
                        lamp_color.append(-1)
        elif isinstance(obj, ir.RayMarched):
            scene.de_shapes.append(_de_shape(obj, add_material(obj.material)))
            if material_is_emissive(scene.de_shapes[-1].material_id):
                print(
                    "Warning: emissive, distance estimated shapes may not "
                    "always produce correct results."
                )
        elif isinstance(obj, ir.DirectionalLight):
            lamp_type.append(LAMP_DIRECTIONAL)
            lamp_ref.append(-1)
            lamp_vec.append(ir.eval_vector3(obj.direction).astype(np.float32))
            lamp_width.append(ir.eval_number(obj.width))
            lamp_color.append(add_color_program(obj.color))
        elif isinstance(obj, ir.PointLight):
            lamp_type.append(LAMP_POINT)
            lamp_ref.append(-1)
            lamp_vec.append(ir.eval_vector3(obj.position).astype(np.float32))
            lamp_width.append(0.0)
            lamp_color.append(add_color_program(obj.color))
        else:
            raise ir.ProjectError(f"unsupported world object {type(obj).__name__}")

    # --- sky -------------------------------------------------------------------
    sky = project.world.sky if project.world.sky is not None else 0.0
    scene.sky_program = exprs.compile_program(sky, resources, exprs.NUMBER)

    num_tris = len(tri_v0)
    num_sph = len(sph_center)
    prim_kind = np.concatenate(
        [np.full(num_tris, PRIM_TRIANGLE, np.int32), np.full(num_sph, PRIM_SPHERE, np.int32)]
    )
    prim_ref = np.concatenate(
        [np.arange(num_tris, dtype=np.int32), np.arange(num_sph, dtype=np.int32)]
    )
    cluster = None
    if num_tris + num_sph > CLUSTER_THRESHOLD:
        cluster = _build_clusters(tri_v0, tri_e1, tri_e2, sph_center, sph_radius)
        perm, rows, clu_geo, leaf_size = cluster
        prim_kind = prim_kind[perm]
        prim_ref = prim_ref[perm]

    def pad1(lst, dtype, pad_value=0, width=None):
        """1-sized padding so zero-length scenes still trace."""
        arr = np.asarray(lst, dtype)
        if len(arr) == 0:
            shape = (1,) if width is None else (1, *width)
            arr = np.full(shape, pad_value, dtype)
        return arr

    host = {
        "tri_v0": pad1(tri_v0, np.float32, 0, (3,)),
        "tri_e1": pad1(tri_e1, np.float32, 0, (3,)),
        "tri_e2": pad1(tri_e2, np.float32, 0, (3,)),
        "tri_n": pad1(tri_n, np.float32, 0, (3, 3)),
        "tri_q": pad1(tri_q, np.float32, 0, (3, 4)),
        "tri_uv": pad1(tri_uv, np.float32, 0, (3, 2)),
        "tri_mat": pad1(tri_mat, np.int32),
        "sph_center": pad1(sph_center, np.float32, 0, (3,)),
        "sph_radius": pad1(sph_radius, np.float32, 1),
        "sph_texscale": pad1(sph_texscale, np.float32, 1, (2,)),
        "sph_mat": pad1(sph_mat, np.int32),
        "pla_normal": pad1(pla_normal, np.float32, 0, (3,)),
        "pla_d": pad1(pla_d, np.float32),
        "pla_quat": pad1(pla_quat, np.float32, 0, (4,)),
        "pla_texscale": pad1(pla_texscale, np.float32, 1, (2,)),
        "pla_mat": pad1(pla_mat, np.int32),
        "prim_kind": pad1(prim_kind, np.int32),
        "prim_ref": pad1(prim_ref, np.int32),
        "mat_comp_offset": pad1(mat_comp_offset, np.int32),
        "mat_comp_count": pad1(mat_comp_count, np.int32, 1),
        "mat_emis_offset": pad1(mat_emis_offset, np.int32),
        "mat_emis_count": pad1(mat_emis_count, np.int32),
        "mat_normal_prog": pad1(mat_normal_prog, np.int32, -1),
        "comp_bsdf": pad1(comp_bsdf, np.int32),
        "comp_color": pad1(comp_color, np.int32),
        "comp_prob": pad1(comp_prob, np.int32, -1),
        "comp_color_uses_wl": pad1(comp_color_uses_wl, bool, False),
        "comp_prob_uses_wl": pad1(comp_prob_uses_wl, bool, False),
        "comp_selection": pad1(comp_selection, np.float32, 1),
        "comp_ior": pad1(comp_ior, np.float32, 1),
        "comp_env_ior": pad1(comp_env_ior, np.float32, 1),
        "comp_disp": pad1(comp_disp, np.float32),
        "comp_env_disp": pad1(comp_env_disp, np.float32),
        "emis_comp": pad1(emis_comp, np.int32),
        "emis_selection": pad1(emis_selection, np.float32, 1),
        "lamp_type": pad1(lamp_type, np.int32, LAMP_POINT),
        "lamp_ref": pad1(lamp_ref, np.int32, -1),
        "lamp_vec": pad1(lamp_vec, np.float32, 0, (3,)),
        "lamp_width": pad1(lamp_width, np.float32),
        "lamp_color": pad1(lamp_color, np.int32, -1),
    }
    if cluster is not None:
        host["wide_rows"], host["clu_geo"] = rows, clu_geo
        scene.use_clusters = True
        scene.cluster_leaf = leaf_size
        scene.cluster_slots = clu_geo.shape[0]
    scene.arrays = {k: torch.as_tensor(v, device=scene.device) for k, v in host.items()}
    scene.num_planes = len(pla_normal)
    scene.num_lamps = len(lamp_type)
    scene.num_triangles = num_tris
    scene.num_spheres = num_sph
    scene.lamp_types = set(lamp_type)
    scene.directional_lamps = [
        (np.asarray(lamp_vec[i], np.float32), float(lamp_width[i]), int(lamp_color[i]))
        for i in range(len(lamp_type))
        if lamp_type[i] == LAMP_DIRECTIONAL
    ]

    programs = scene.color_programs + scene.prob_programs + [scene.sky_program]
    scene.frames = bool(scene.normal_programs) or any(p.uses_texture for p in programs)

    bake_bank_tables(scene, project.renderer.spectrum_span)
    scene.spectrum_samples = project.renderer.spectrum_samples
    if project.renderer.algorithm == "photon_mapping":
        scene.photon_widths = photon_widths(project, exact_chain_mode(scene))
    from . import kernels_dense

    scene.dense_pack = kernels_dense.build_pack(scene, host)
    return scene


def _de_shape(obj, mid) -> DEShape:
    """A RayMarched object's estimator dict and bounds, built exactly as the
    JAX package builds them (scene.py:577-620)."""
    est = obj.shape
    if isinstance(est, ir.Mandelbulb):
        estimator = {
            "kind": "mandelbulb",
            "iterations": int(ir.eval_number(est.iterations)),
            "threshold": ir.eval_number(est.threshold),
            "power": ir.eval_number(est.power),
            "constant": None if est.constant is None else ir.eval_vector3(est.constant),
        }
    else:
        estimator = {
            "kind": "quaternion_julia",
            "iterations": int(ir.eval_number(est.iterations)),
            "threshold": ir.eval_number(est.threshold),
            "constant": ir.eval_vector4(est.constant),
            "slice_plane": ir.eval_number(est.slice_plane),
            "variant": est.variant,
        }
    if isinstance(obj.bounds, ir.BoundingBox):
        kind, a, b = "box", ir.eval_vector3(obj.bounds.min), ir.eval_vector3(obj.bounds.max)
    else:
        kind = "sphere"
        a = ir.eval_vector3(obj.bounds.position)
        b = np.array([ir.eval_number(obj.bounds.radius), 0.0, 0.0], np.float32)
    return DEShape(estimator, kind, a.astype(np.float32), b.astype(np.float32), mid)


def _build_clusters(tri_v0, tri_e1, tri_e2, sph_center, sph_radius):
    """The clustered wide BVH over the triangles and spheres (the cluster
    branch of the JAX package's build_scene, scene.py:640-742).

    The binary SAH build (the native C++ builder, or the numpy one where no
    C++ toolchain is found, as in the JAX package) serves only for its
    depth-first primitive ORDER; its treelets become the leaf clusters.
    Returns (perm, wide_rows [273, 128], clu_geo [slots, leaf, 12], leaf)."""
    num_tris, num_sph = len(tri_v0), len(sph_center)
    total = num_tris + num_sph
    t_v0 = np.asarray(tri_v0, np.float32).reshape(-1, 3)
    t_e1 = np.asarray(tri_e1, np.float32).reshape(-1, 3)
    t_e2 = np.asarray(tri_e2, np.float32).reshape(-1, 3)
    t_lo = np.minimum(np.minimum(t_v0, t_v0 + t_e1), t_v0 + t_e2)
    t_hi = np.maximum(np.maximum(t_v0, t_v0 + t_e1), t_v0 + t_e2)
    s_c = np.asarray(sph_center, np.float32).reshape(-1, 3)
    s_r = np.asarray(sph_radius, np.float32)
    prim_lo = np.concatenate([t_lo, s_c - s_r[:, None]])
    prim_hi = np.concatenate([t_hi, s_c + s_r[:, None]])
    kind = np.concatenate(
        [np.full(num_tris, PRIM_TRIANGLE, np.int32), np.full(num_sph, PRIM_SPHERE, np.int32)]
    )
    ref = np.concatenate([np.arange(num_tris, dtype=np.int32), np.arange(num_sph, dtype=np.int32)])

    order_leaf = 32  # a small leaf gives a finer depth-first order
    clustered = native.build_bvh_clustered(prim_lo, prim_hi, order_leaf)
    if clustered is None:
        clustered = bvh_mod.build_bvh_clustered_python(prim_lo, prim_hi, order_leaf)
    perm = clustered[5]
    kind, ref = kind[perm], ref[perm]

    # one [12] f32 row per primitive, in perm order: v0 or center, e1, e2,
    # radius, kind, ref
    geo = np.zeros((total, 12), np.float32)
    tm = kind == PRIM_TRIANGLE
    sm = ~tm
    geo[tm, 0:3] = t_v0[ref[tm]]
    geo[tm, 3:6] = t_e1[ref[tm]]
    geo[tm, 6:9] = t_e2[ref[tm]]
    geo[sm, 0:3] = s_c[ref[sm]]
    geo[sm, 9] = s_r[ref[sm]]
    geo[:, 10] = kind
    geo[:, 11] = ref

    ranges, leaf_size = cluster_ranges(
        clustered[2], clustered[3], clustered[4], cluster_leaf_size(total),
        bvh_mod.WIDE_FANOUT**bvh_mod.WIDE_LEVELS,
    )
    rows, clu_geo = pack_wide_clusters_ranges(prim_lo[perm], prim_hi[perm], geo, ranges, leaf_size)
    return perm, rows, clu_geo, leaf_size


def cluster_ranges(subtree, start, count, leaf_size, capacity):
    """The leaf clusters of a clustered binary SAH tree: its treelets of at
    most ``leaf_size`` primitives, merged until at most ``capacity`` remain,
    with the leaf grown by 128 while they do not fit (scene.py:716-727 of
    the JAX package). Returns (ranges, leaf_size)."""
    while True:
        ranges = bvh_mod.treelet_ranges(subtree, start, count, leaf_size)
        if len(ranges) <= capacity:
            return ranges, leaf_size
        try:
            return bvh_mod.merge_ranges(ranges, leaf_size, capacity), leaf_size
        except ValueError:
            leaf_size += 128  # denser clusters until the tree fits


# Program banks switch from the exact per-program masked loop to one shared
# interpolation table once this many lambda-only programs exist.
BANK_TABLE_MIN = 8
BANK_GRID = 4096  # ~0.1 nm spacing over a 400 nm span


def bake_bank_tables(scene: Scene, span) -> None:
    """Bake lambda-only color/probability programs into [P, BANK_GRID]
    lookup tables (linear interpolation at eval time, tracer.eval_color_bank)
    once a scene has BANK_TABLE_MIN of them; small banks keep the exact
    per-program evaluation."""
    lam = torch.as_tensor(np.linspace(span[0], span[1], BANK_GRID).astype(np.float32))

    def bake(progs, key):
        bakeable = [not p.uses_ray_inputs for p in progs]
        if sum(bakeable) < BANK_TABLE_MIN:
            return None
        table = torch.zeros((len(progs), BANK_GRID), dtype=torch.float32)
        for i, (prog, ok) in enumerate(zip(progs, bakeable)):
            if ok:
                table[i, :] = prog(exprs.ProgramInputs(wavelength=lam)).expand(BANK_GRID)
        scene.arrays[key] = table.to(scene.device)
        return bakeable

    scene.color_bank_bakeable = bake(scene.color_programs, "color_bank")
    scene.prob_bank_bakeable = bake(scene.prob_programs, "prob_bank")
    scene.bank_span = (float(span[0]), float(span[1]))


@dataclass
class CameraModel:
    """Thin-lens perspective camera (cameras.rs)."""

    transform: np.ndarray  # 4x4 camera->world
    view_plane: float
    focus_distance: float
    aperture: float

    @staticmethod
    def from_ir(cam: ir.Camera) -> "CameraModel":
        fov = ir.eval_number(cam.fov)
        half = math.radians(fov * 0.5)
        return CameraModel(
            transform=_look_at_matrix(cam.transform),
            view_plane=math.cos(half) / math.sin(half),
            focus_distance=1.0 if cam.focus_distance is None else ir.eval_number(cam.focus_distance),
            aperture=0.0 if cam.aperture is None else ir.eval_number(cam.aperture),
        )

    def ray_towards(self, target_xy, u1, u2):
        """Batched primary ray generation (cameras.rs:70-97).

        ``target_xy``: [N, 2] view-plane coordinates; u1/u2: [N] uniforms.
        Returns (origin [N, 3], direction [N, 3])."""
        focus_x = target_xy[:, 0] / self.view_plane * self.focus_distance
        focus_y = target_xy[:, 1] / self.view_plane * self.focus_distance
        target = torch.stack(
            [focus_x, -focus_y, torch.full_like(focus_x, -self.focus_distance)], dim=-1
        )
        if self.aperture > 0.0:
            sqrt_r = torch.sqrt(self.aperture * u1)
            psi = 2.0 * math.pi * u2
            origin = torch.stack(
                [sqrt_r * torch.cos(psi), sqrt_r * torch.sin(psi), torch.zeros_like(u1)], dim=-1
            )
            direction = geom.normalize(target - origin)
        else:
            origin = torch.zeros_like(target)
            direction = geom.normalize(target)
        # the 3x3 product written out, ((x m0 + y m1) + z m2) per component:
        # a matrix product's rounding may change with the batch, and a lane's
        # ray must not depend on the wavefront it rides in (the regeneration
        # scheduler's lanes equal the one-shot wavefront's)
        m = [[float(v) for v in row] for row in np.asarray(self.transform, np.float32)[:3]]

        def rotate(v):
            return torch.stack(
                [v[:, 0] * r[0] + v[:, 1] * r[1] + v[:, 2] * r[2] for r in m], dim=-1)

        world_origin = rotate(origin) + torch.tensor([r[3] for r in m], device=origin.device)
        return world_origin, rotate(direction)


def camera_inverse_project(camera: CameraModel, targets, u1, u2):
    """Project world points back through the lens to view coordinates
    (pyrite_tpu.scene.camera_inverse_project, cameras.rs:99-158 is_visible
    without the world occlusion test): ``targets`` [N, 3], lens uniforms
    u1 / u2 [N]. Returns (view_xy [N, 2], world_origin [N, 3], direction
    [N, 3], distance [N], ok [N]: the point lies in front of the camera).
    The rotations are written out as three sums per component, as in
    CameraModel.ray_towards, so a lane's result does not depend on its
    batch."""
    m = [[float(v) for v in row] for row in np.asarray(camera.transform, np.float32)[:3]]
    trans = torch.tensor([r[3] for r in m], device=targets.device)
    # the inverse of a rigid transform: R^T (x - t)
    rel = targets - trans
    local = torch.stack(
        [rel[:, 0] * m[0][j] + rel[:, 1] * m[1][j] + rel[:, 2] * m[2][j] for j in range(3)], dim=-1)
    ok = local[:, 2] < 0.0
    if camera.aperture > 0.0:
        sqrt_r = torch.sqrt(camera.aperture * u1)
        psi = 2.0 * math.pi * u2
        origin_local = torch.stack(
            [sqrt_r * torch.cos(psi), sqrt_r * torch.sin(psi), torch.zeros_like(u1)], dim=-1)
    else:
        origin_local = torch.zeros_like(targets)
    world_origin = torch.stack(
        [origin_local[:, 0] * r[0] + origin_local[:, 1] * r[1] + origin_local[:, 2] * r[2]
         for r in m], dim=-1) + trans
    direction = targets - world_origin
    distance = torch.sqrt(torch.clamp(geom.dot(direction, direction), min=1e-20))
    direction = direction / distance[:, None]

    fd = float(camera.focus_distance)
    l1 = local + torch.tensor([0.0, 0.0, fd], device=targets.device)
    dist_z = l1[:, 2]
    l2 = l1 - origin_local * (dist_z / fd)[:, None]
    l3 = l2 - torch.tensor([0.0, 0.0, fd], device=targets.device)
    denom = torch.where(torch.abs(l3[:, 2]) < 1e-12, 1.0, l3[:, 2])
    vpt = -l3 / denom[:, None]
    view_xy = torch.stack([vpt[:, 0] * camera.view_plane, -vpt[:, 1] * camera.view_plane], dim=-1)
    return view_xy, world_origin, direction, distance, ok
