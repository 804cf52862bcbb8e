"""The bounce on the GPU: scene pack, per-launch program values, and the
wrapper that launches the CUDA kernels of csrc/bounce.cu (PyTorch port of
pyrite_tpu.kernels_dense, extended to mesh scenes).

A bounce is two launches: the BOUNCE kernel (closest hit, miss/sky,
component pick, probability programs, BSDF scatter, emission, reflectance
update) and the NEE kernel (lamp sample, shadow query and contribution for
each light sample). One thread owns one lane in both. A dense scene runs
dense_bounce_kernel / dense_nee_kernel, which sweep its <= 128 primitives;
a mesh scene (scene.use_clusters) runs wide_bounce_kernel / wide_nee_kernel,
which walk its clustered wide BVH. On a scene with distance-estimated (DE)
shapes a bounce is four launches: the march pass (march_de_kernel over each
DE shape and bounce ray, ``march_pass``), the bounce kernel, the shadow
march pass (over each DE shape and NEE shadow ray, ``shadow_pass``) and the
NEE kernel; the two kernels read the passes' t of each shape after the
primitives. ``bounce_dense`` takes the plain version, tracer.bounce_core,
for tensors on the CPU, and launches the kernels for tensors on a GPU, or
raises; there is no fallback.

The bidirectional renderer's steps take the same route: ``bounce_dense``
with ``record`` (the bounce kernels' kRecord instantiations, which also
write the camera vertex), ``lamp_start`` / ``lamp_bounce`` (the lamp
kernels, after a march pass on a DE scene) and ``shadow_query``
(dense_shadow_kernel, or wide_shadow_kernel on a mesh scene, after a query
march pass on a DE scene), each with its plain version for CPU tensors.

The scene reaches the kernels as an [R, 128] f32 sheet, plus ``meta`` (the
row of each table, in META_FIELDS order, which csrc/common.cuh's enum
mirrors) and the postfix code of the programs that read the ray
(exprs.KernelPrograms). On a dense scene the sheet is the JAX package's
(same rows, same values), with a few rows more on a scene whose programs
need the kernels' kProg instantiations (META_FIELDS' last). A mesh scene's sheet
keeps the plane, material, component, lamp and emissive tables and has no
primitive rows: its kernels read the node table, the leaf clusters and the
triangle and sphere tables as flat tensors. The DE shapes take one column
each of the rows DE_FIELDS names (de_fields); a table of more than 128
entries runs on over consecutive rows. Programs of the wavelength alone
are evaluated once per launch, or read from the scene's baked table where
it has one, and the leaves of those that read the ray once per launch
(precompute_bank_values).

A scene with image textures, normal maps, color or sky programs that read
the ray, or probability programs that read the ray beyond the simple form
(exprs.SIMPLE_OPS) runs the kernels' kProg instantiations ("<prog>" in
their names and counts): they compute each hit's frame and uv, map the
normal before the component pick, and interpret each program's lane code
once per lane and its column code per spectral column (csrc/bounce.cu
eval_program). Every other scene runs the instantiations it ran before.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import exprs
from . import geometry as geom
from . import tracer
from .rng import INT_MAX
from .scene import BANK_GRID
from .scene import (
    LAMP_DIRECTIONAL, LAMP_POINT, LAMP_SPHERE, LAMP_TRIANGLE, PRIM_SPHERE, PRIM_TRIANGLE,
)

SHEET_WIDTH = 128
BLOCK = 128  # threads a block (csrc/common.cuh)
GATHER_ROW = 16  # csrc/bounce.cu MAX_ROW: the widest row the simple code stages
# The scene's form, which picks the bounce and NEE kernels' instantiation
# (csrc/bounce.cu FORM_*): the simple code, the kProg code, or the simple
# code with what the scene gate took last (kGate: directional lamps, baked
# program tables, rows past GATHER_ROW columns), kept apart because it
# slowed the simple code on scenes that have none of it (PERF.md §6).
FORM_SIMPLE, FORM_PROG, FORM_GATE = 0, 1, 2
# The shared memory one block may take on an H100 once the launcher opts in
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KiB), less 1 KiB for the
# kernels' static arrays. No kernel's dynamic shared memory grows with S
# past a fixed bound (launch_smem: the launchers' own measures). The kProg
# program stack grows with a program's depth up to exprs.PROG_STACK_MAX,
# which every launcher holds at any S (a deeper program is lowered in
# Sethi-Ullman order, exprs.KernelPrograms); march_de_kernel reads each DE
# shape from the sheet and takes none; past what a block holds, the photon
# film's bins live in the gather's output row (gather_out_row).
SMEM_PER_BLOCK = 227 * 1024 - 1024
_DE_SLOT_BYTES = 4 * (BLOCK // 32) * (32 * 3 + 32 + 32 * 6)  # csrc/bounce.cu DE_SLOT_FLOATS
_ROW_OP_FLOATS = 8  # csrc/bounce.cu sizeof(RowOp) / 4 (a pointer and five words, 8-aligned)
# csrc/bounce.cu OWN_STRIDE and RECORD_STRIDE: a kProg block's slot a lane
# for a chunk of its own colour row past GATHER_ROW columns, of ROW_CHUNK =
# 16 columns (the simple renderer's bounce, the NEE) or RECORD_CHUNK = 128
# (the kRecord bounce)
_OWN_STRIDE, _RECORD_STRIDE = 17, 129
_GEO_ROWS = 22  # rows 0..21: primitive channels (see build_pack)

# A DE shape's parameters, in the order of csrc/march_de.cuh's de_shape:
# estimator kind (0 Mandelbulb, 1 quaternion Julia), Julia variant (0
# regular, 1 cubic, 2 bicomplex), iterations, escape threshold and its square
# (as the JAX package rounds it), power and power - 1 (Mandelbulb), whether
# the Mandelbulb has a constant, the constant (x, y, z, w), the Julia slice
# plane, bounds kind (0 box, 1 sphere), bounds_a, bounds_b, the local
# origin (DEShape.center), the material.
DE_FIELDS = (
    "kind", "variant", "iterations", "threshold", "thr2", "power", "power_m1",
    "has_constant", "c0", "c1", "c2", "c3", "slice", "bounds_kind",
    "ax", "ay", "az", "bx", "by", "bz", "cx", "cy", "cz", "mat",
)
_JULIA_VARIANTS = {"regular": 0, "cubic": 1, "bicomplex": 2}

# csrc/common.cuh `enum Meta`, in order
META_FIELDS = (
    "n_prims", "n_planes", "n_de",
    "pla_nx", "pla_ny", "pla_nz", "pla_d", "pla_mat",
    "mat_comp_count", "mat_comp_offset", "mat_emis_count", "mat_emis_offset",
    "comp_bsdf", "comp_color", "comp_prob", "comp_prob_uses_wl", "comp_selection",
    "comp_ior", "comp_disp", "comp_env_ior", "comp_env_disp",
    "lamp_type", "lamp_vx", "lamp_vy", "lamp_vz", "lamp_ref", "lamp_color",
    "lsph_cx", "lsph_cy", "lsph_cz", "lsph_r", "lsph_mat",
    "ltri_v0x", "ltri_v0y", "ltri_v0z", "ltri_e1x", "ltri_e1y", "ltri_e1z",
    "ltri_e2x", "ltri_e2y", "ltri_e2z",
    "ltri_n0x", "ltri_n0y", "ltri_n0z", "ltri_n1x", "ltri_n1y", "ltri_n1z",
    "ltri_n2x", "ltri_n2y", "ltri_n2z", "ltri_mat",
    "emis_comp", "emis_selection",
) + tuple("de_" + f for f in DE_FIELDS) + (
    # the kProg instantiations' rows: each material's normal program (-1
    # none), each shape lamp's texture scale and triangle vertex uv
    "mat_normal", "lsph_tsu", "lsph_tsv",
    "ltri_uv0u", "ltri_uv0v", "ltri_uv1u", "ltri_uv1v", "ltri_uv2u", "ltri_uv2v",
    # on a scene with directional lamps: their count, every lamp's width (a
    # cosine), and their own table in lamp order (direction, width, color
    # program), which the bounce kernels scan on a miss
    "n_dir", "lamp_width", "dir_vx", "dir_vy", "dir_vz", "dir_width", "dir_color",
)

# the extern "C" launcher of each kernel (csrc/bounce.cu); a "<prog>"
# name is the kProg instantiation, which the same launcher picks from its
# `prog` argument
_LAUNCHERS = {
    "dense_bounce_kernel": "pyrite_dense_bounce", "dense_nee_kernel": "pyrite_dense_nee",
    "wide_bounce_kernel": "pyrite_wide_bounce", "wide_nee_kernel": "pyrite_wide_nee",
    "de_march_pass": "pyrite_de_march_bounce", "de_shadow_pass": "pyrite_de_march_shadow",
    "dense_bounce_kernel<record>": "pyrite_dense_bounce_record",
    "wide_bounce_kernel<record>": "pyrite_wide_bounce_record",
    "dense_lamp_kernel": "pyrite_dense_lamp", "wide_lamp_kernel": "pyrite_wide_lamp",
    "dense_shadow_kernel": "pyrite_dense_shadow", "de_query_pass": "pyrite_de_march_query_shadow",
    "program_colors_kernel": "pyrite_program_colors",
    "photon_gather_kernel": "pyrite_photon_gather",
}
# past a block's shared memory the gather's <out_row> form: the same launcher
_LAUNCHERS["photon_gather_kernel<out_row>"] = _LAUNCHERS["photon_gather_kernel"]


def prog_name(name):
    """The kProg instantiation's name of kernel ``name``."""
    return name[:-1] + ",prog>" if name.endswith(">") else name + "<prog>"


_LAUNCHERS.update({prog_name(k): _LAUNCHERS[k] for k in (
    "dense_bounce_kernel", "dense_nee_kernel", "wide_bounce_kernel", "wide_nee_kernel",
    "dense_bounce_kernel<record>", "wide_bounce_kernel<record>", "dense_lamp_kernel",
    "wide_lamp_kernel",
)})

# Each wrapper adds one here where it launches its kernel; "de_march_pass"
# and "de_shadow_pass" count march_de_kernel's launches over the bounce rays
# and over the shadow rays, "de_query_pass" over a shadow_query batch. The
# bidirectional renderer's kernels: the bounce kernels' kRecord
# instantiations ("<record>"), the lamp kernels, dense_shadow_kernel and
# program_colors_kernel (its lamp vertices' colors on a scene whose color
# programs read the ray); the photon renderer's, the same and
# photon_gather_kernel. The kProg instantiations count apart, and so does
# the gather's <out_row> form.
launches = dict.fromkeys(_LAUNCHERS, 0)


def estimator_fields(est):
    """The estimator's part of DE_FIELDS (kind .. slice), f32."""
    julia = est["kind"] != "mandelbulb"
    constant = est["constant"]
    c = np.zeros(4, np.float32)
    if constant is not None:
        c[: len(constant)] = constant
    threshold = float(est["threshold"])
    power = float(est.get("power", 0.0))
    return np.asarray([
        1.0 if julia else 0.0,
        _JULIA_VARIANTS[est["variant"]] if julia else 0.0,
        est["iterations"], threshold, threshold * threshold, power, power - 1.0,
        0.0 if constant is None else 1.0, *c, est.get("slice_plane", 0.0),
    ], np.float32)


def de_fields(shape):
    """A scene.DEShape's DE_FIELDS values, f32 as the kernels read them."""
    bounds = [0.0 if shape.bounds_kind == "box" else 1.0, *shape.bounds_a, *shape.bounds_b,
              *shape.center, shape.material_id]
    return np.concatenate([estimator_fields(shape.estimator), np.asarray(bounds, np.float32)])


def _own_floats(s, stride=_OWN_STRIDE):
    """csrc/bounce.cu OWN_FLOATS: the floats of a kProg block's own colour
    rows a lane, the whole row at S <= GATHER_ROW, a chunk's slot past it."""
    return s if s <= GATHER_ROW else stride


def _stack_bytes(form, stack):
    """The kProg program stack a block, [stack, BLOCK] float4 (STACK_BYTES)."""
    return 16 * BLOCK * stack if form == FORM_PROG else 0


def _stream_bytes(de, own=0):
    """csrc/bounce.cu stream_smem_bytes: [BLOCK, 12] floats of vectors, a
    row op a lane and ``own`` floats a lane, with a warp's DE probe slots."""
    return 4 * BLOCK * (12 + _ROW_OP_FLOATS + own) + (_DE_SLOT_BYTES if de else 0)


def bounce_smem_bytes(s, de, form, stack):
    """The dynamic shared memory of a block of the simple renderer's bounce
    kernels at S spectral columns, as their launchers pass it
    (csrc/bounce.cu BOUNCE_SMEM, plus the program stack): at S <=
    GATHER_ROW the staged rows, [BLOCK, 4 S + 12] floats; past it the
    streamed forms, the kProg one with a chunk's slot of its own rows a
    lane; with a warp's DE probe slots on a scene with DE shapes."""
    if s > GATHER_ROW and form != FORM_SIMPLE:
        own = _stream_bytes(de, _OWN_STRIDE if form == FORM_PROG else 0)
    else:
        own = 4 * BLOCK * (4 * s + 12) + (_DE_SLOT_BYTES if de else 0)
    return own + _stack_bytes(form, stack)


def nee_smem_bytes(s, form, stack):
    """The same for the NEE kernels (csrc/bounce.cu NEE_SMEM): on a kProg
    scene the colour rows, [BLOCK, S] floats at S <= GATHER_ROW and a
    chunk's slot past it, and the program stack; none elsewhere."""
    return 4 * BLOCK * _own_floats(s) + _stack_bytes(form, stack) if form == FORM_PROG else 0


def record_smem_bytes(s, de, form, stack):
    """The dynamic shared memory of a block of the bounce kernels' kRecord
    instantiations at S spectral columns, as their launchers pass it
    (csrc/bounce.cu RECORD_SMEM, plus the kProg program stack of ``stack``
    values): every form streams its rows, [BLOCK, 12] floats of vectors
    and a row op a lane, [BLOCK, 12 + 8]; a FORM_PROG scene's block keeps
    each lane's own colour row besides, whole at S <= GATHER_ROW ([BLOCK,
    12 + 8 + S]) and a chunk's slot past it ([BLOCK, 12 + 8 + 129]); with a
    warp's DE probe slots on a scene with DE shapes."""
    own = _own_floats(s, _RECORD_STRIDE) if form == FORM_PROG else 0
    return _stream_bytes(de, own) + _stack_bytes(form, stack)


def lamp_smem_bytes(de, form, stack):
    """The same for the lamp kernels (csrc/bounce.cu lamp_smem_bytes): a
    warp's DE probe slots and the program stack, whatever S."""
    return (_DE_SLOT_BYTES if de else 0) + _stack_bytes(form, stack)


def launch_smem(widths, de, form, stack, bins=None):
    """{kernel: bytes}: the most dynamic shared memory each kernel that a
    scene's renderers launch passes, over the spectral ``widths`` they
    launch at (S first; the photon renderer's S + G and 1 + B too), the
    launchers' own measures: the bounce, NEE, kRecord and lamp kernels,
    program_colors_kernel (its stack and a ring of 64 slots a warp), the
    draws' camera rows at S (rng.draws_smem_bytes) and, given the photon film's
    ``bins``, photon_gather_kernel (gather_smem_bytes at K = S, in the form
    gather_out_row picks). None of them grows with S past a fixed bound."""
    from .rng import draws_smem_bytes

    out = {
        "bounce": max(bounce_smem_bytes(w, de, form, stack) for w in widths),
        "nee": max(nee_smem_bytes(w, form, stack) for w in widths),
        "record": max(record_smem_bytes(w, de, form, stack) for w in widths),
        "lamp": lamp_smem_bytes(de, form, stack),
        "colors": 4 * (BLOCK // 32) * 64 + _stack_bytes(form, stack),
        "draws": draws_smem_bytes(widths[0]),
    }
    if bins is not None:
        out["gather"] = gather_smem_bytes(bins, widths[0], gather_out_row(bins, widths[0]))
    return out


def build_pack(scene, a):
    """Gate + packed scene sheet from the host (numpy) scene arrays ``a``.

    The gate takes every scene the JAX package builds: any spectral width S
    >= 1 (launch_smem: no kernel's shared memory grows with S past a fixed
    bound), the photon renderer's S + G camera and 1 + B lamp columns too
    (scene.photon_widths); a dense scene (at most scene.CLUSTER_THRESHOLD =
    128 finite primitives) of no finite primitive, beside DE shapes or
    planes alone (the JAX package keeps both out of its dense pack and runs
    them in XLA); any number of DE shapes (march_de_kernel reads each from
    the sheet) and photon film bins (gather_out_row); programs of any depth (exprs.KernelPrograms). A table
    of more than 128 entries (materials, components, lamps, planes, DE
    shapes) takes consecutive sheet rows. Returns a dict with the [R, 128]
    sheet, the row indices (``meta``), the lowered programs
    (``programs``), whether the scene runs the kProg instantiations
    (``prog``), its ``form`` (FORM_*), their program stack (``stack``,
    values a thread; 0 on the simple ones), each kernel's dynamic shared
    memory at the scene's widths (``smem``, launch_smem) and the device
    tensors the kernels read."""
    clusters = scene.use_clusters
    n_de = len(scene.de_shapes)
    assert clusters or scene.num_primitives <= 128, scene.num_primitives  # scene.CLUSTER_THRESHOLD
    lamp_types = set(a["lamp_type"].tolist()) if scene.num_lamps else set()
    assert lamp_types <= {LAMP_DIRECTIONAL, LAMP_POINT, LAMP_SPHERE, LAMP_TRIANGLE}, lamp_types
    programs = exprs.KernelPrograms(scene, scene.resources)
    prog = not programs.simple
    stack = programs.stack_depth if prog else 0
    s = scene.spectrum_samples
    if s < 1:
        raise ValueError(f"{s} spectrum samples; a scene takes at least 1")
    photon = scene.photon_widths
    widths = (s,) if photon is None else (s, photon["camera"], photon["lamp"])
    gate = bool(scene.directional_lamps) or max(widths) > GATHER_ROW or (
        scene.color_bank_bakeable is not None or scene.prob_bank_bakeable is not None)
    form = FORM_PROG if prog else FORM_GATE if gate else FORM_SIMPLE
    smem = launch_smem(widths, n_de > 0, form, stack, None if photon is None else photon["bins"])
    assert max(smem.values()) <= SMEM_PER_BLOCK, smem  # the stack is exprs.PROG_STACK_MAX's

    def row(values):
        out = np.zeros(SHEET_WIDTH, np.float32)
        v = np.asarray(values, np.float32).reshape(-1)
        out[: v.shape[0]] = v
        return out

    meta = {"n_prims": 0 if clusters else scene.num_primitives, "n_planes": scene.num_planes,
            "n_de": n_de}
    rows = [] if clusters else _primitive_rows(scene, a, row)

    def add(name, values):
        """Table ``name``: ceil(n / 128) consecutive rows (one for none)."""
        meta[name] = len(rows)
        v = np.asarray(values, np.float32).reshape(-1)
        rows.extend(row(v[i:i + SHEET_WIDTH]) for i in range(0, max(len(v), 1), SHEET_WIDTH))

    if scene.num_planes:
        pn = a["pla_normal"]
        add("pla_nx", pn[:, 0]); add("pla_ny", pn[:, 1]); add("pla_nz", pn[:, 2])
        add("pla_d", a["pla_d"]); add("pla_mat", a["pla_mat"])
    for name in (
        "mat_comp_count", "mat_comp_offset", "mat_emis_count", "mat_emis_offset",
        "comp_bsdf", "comp_color", "comp_prob",
    ):
        add(name, a[name])
    add("comp_prob_uses_wl", a["comp_prob_uses_wl"].astype(np.float32))
    for name in ("comp_selection", "comp_ior", "comp_disp", "comp_env_ior", "comp_env_disp"):
        add(name, a[name])
    shapes = None
    if scene.num_lamps:
        lamp_ref = a["lamp_ref"]
        shapes = {
            k: a[k] for k in (
                "sph_center", "sph_radius", "sph_mat", "tri_v0", "tri_e1", "tri_e2", "tri_n",
                "tri_mat", "sph_texscale", "tri_uv",
            )
        }
        if clusters:
            # a mesh has more triangles than a sheet row holds: the lamp
            # rows hold each lamp's own sphere or triangle, and lamp_ref
            # points at the lamp's own column
            shapes = {k: v[np.clip(lamp_ref, 0, len(v) - 1)] for k, v in shapes.items()}
            lamp_ref = np.where(lamp_ref >= 0, np.arange(len(lamp_ref)), -1)
        add("lamp_type", a["lamp_type"])
        lv = a["lamp_vec"]
        add("lamp_vx", lv[:, 0]); add("lamp_vy", lv[:, 1]); add("lamp_vz", lv[:, 2])
        add("lamp_ref", lamp_ref); add("lamp_color", a["lamp_color"])
        sc = shapes["sph_center"]
        add("lsph_cx", sc[:, 0]); add("lsph_cy", sc[:, 1]); add("lsph_cz", sc[:, 2])
        add("lsph_r", shapes["sph_radius"]); add("lsph_mat", shapes["sph_mat"])
        for vec, key in (("v0", "tri_v0"), ("e1", "tri_e1"), ("e2", "tri_e2")):
            for axis, comp in enumerate("xyz"):
                add(f"ltri_{vec}{comp}", shapes[key][:, axis])
        for vtx in range(3):
            for axis, comp in enumerate("xyz"):
                add(f"ltri_n{vtx}{comp}", shapes["tri_n"][:, vtx, axis])
        add("ltri_mat", shapes["tri_mat"])
        add("emis_comp", a["emis_comp"])
        add("emis_selection", a["emis_selection"])
    if n_de:
        table = np.stack([de_fields(shape) for shape in scene.de_shapes])
        for i, field in enumerate(DE_FIELDS):
            add("de_" + field, table[:, i])
    if prog:
        add("mat_normal", a["mat_normal_prog"])
        if shapes is not None:
            add("lsph_tsu", shapes["sph_texscale"][:, 0]); add("lsph_tsv", shapes["sph_texscale"][:, 1])
            for vtx in range(3):
                for axis, comp in enumerate("uv"):
                    add(f"ltri_uv{vtx}{comp}", shapes["tri_uv"][:, vtx, axis])
    if scene.directional_lamps:  # after the JAX package's rows (it packs no such scene)
        meta["n_dir"] = len(scene.directional_lamps)
        add("lamp_width", a["lamp_width"])
        dirs = np.array([d for d, _, _ in scene.directional_lamps], np.float32)
        add("dir_vx", dirs[:, 0]); add("dir_vy", dirs[:, 1]); add("dir_vz", dirs[:, 2])
        add("dir_width", [w for _, w, _ in scene.directional_lamps])
        add("dir_color", [c for _, _, c in scene.directional_lamps])
    sheet = np.stack(rows)

    # the kProg instantiations read each program as its lane and column
    # code, the simple ones the one stream (exprs.KernelPrograms)
    code, off = (programs.split, programs.split_off) if prog else (programs.code, programs.off)
    code = code or [(exprs.OP_CONST, 0.0, 0)]
    dev = scene.device
    textures = programs.tables(dev)
    # each texture starts on a 16-byte boundary, so a colour texel (4
    # floats) is one aligned float4 load; a mono texel is one float
    info = np.zeros((max(len(textures), 1), 4), np.int32)  # offset, height, width, channels
    offset, flat = 0, []
    for i, t in enumerate(textures):
        channels = 1 if t.ndim == 2 else t.shape[2]
        assert channels in (1, 4), "textures are mono or RGBA"
        info[i] = offset, t.shape[0], t.shape[1], channels
        flat += [t.reshape(-1), t.new_zeros(-t.numel() % 4)]
        offset += t.numel() + (-t.numel() % 4)
    tensors = {
        "sheet": torch.as_tensor(sheet, device=dev),
        "meta": torch.as_tensor(
            np.array([meta.get(f, -1) for f in META_FIELDS], np.int32), device=dev
        ),
        "code_op": torch.as_tensor(np.array([c[0] for c in code], np.int32), device=dev),
        "code_val": torch.as_tensor(np.array([c[1] for c in code], np.float32), device=dev),
        "code_arg": torch.as_tensor(np.array([c[2] for c in code], np.int32), device=dev),
        "code_off": torch.as_tensor(np.array(off, np.int32), device=dev),
        "vecs": torch.as_tensor(np.array(programs.vecs or [(0.0,) * 4], np.float32), device=dev),
        "tex": torch.cat(flat) if textures else torch.zeros(1, device=dev),
        "tex_info": torch.as_tensor(info, device=dev),
    }
    return {"sheet": sheet, "meta": meta, "programs": programs, "prog": prog, "form": form,
            "stack": stack, "smem": smem, "tensors": tensors}


def _primitive_rows(scene, a, row):
    """A dense scene's sheet rows 0..21: the primitive channels (cx cy cz e1
    e2 r kind ref mat, triangle vertex normals) in the order of the
    prim_kind/prim_ref tables."""
    p = scene.num_primitives
    kind, ref = a["prim_kind"][:p], a["prim_ref"][:p]  # unpadded when p = 0
    cx, cy, cz = np.zeros(p, np.float32), np.zeros(p, np.float32), np.zeros(p, np.float32)
    e1 = np.zeros((p, 3), np.float32)
    e2 = np.zeros((p, 3), np.float32)
    rad = np.zeros(p, np.float32)
    mat = np.zeros(p, np.float32)
    nrm = np.zeros((p, 3, 3), np.float32)
    tri_sel = kind == PRIM_TRIANGLE
    sph_sel = kind == PRIM_SPHERE
    if tri_sel.any():
        t_ref = ref[tri_sel]
        v0 = a["tri_v0"][t_ref]
        cx[tri_sel], cy[tri_sel], cz[tri_sel] = v0[:, 0], v0[:, 1], v0[:, 2]
        e1[tri_sel] = a["tri_e1"][t_ref]
        e2[tri_sel] = a["tri_e2"][t_ref]
        mat[tri_sel] = a["tri_mat"][t_ref]
        nrm[tri_sel] = a["tri_n"][t_ref]
    if sph_sel.any():
        s_ref = ref[sph_sel]
        c = a["sph_center"][s_ref]
        cx[sph_sel], cy[sph_sel], cz[sph_sel] = c[:, 0], c[:, 1], c[:, 2]
        rad[sph_sel] = a["sph_radius"][s_ref]
        mat[sph_sel] = a["sph_mat"][s_ref]

    pk = np.full(SHEET_WIDTH, -1.0, np.float32)
    pk[:p] = kind
    rows = [
        row(cx), row(cy), row(cz),
        row(e1[:, 0]), row(e1[:, 1]), row(e1[:, 2]),
        row(e2[:, 0]), row(e2[:, 1]), row(e2[:, 2]),
        row(rad), pk, row(ref), row(mat),
        row(nrm[:, 0, 0]), row(nrm[:, 0, 1]), row(nrm[:, 0, 2]),
        row(nrm[:, 1, 0]), row(nrm[:, 1, 1]), row(nrm[:, 1, 2]),
        row(nrm[:, 2, 0]), row(nrm[:, 2, 1]), row(nrm[:, 2, 2]),
    ]
    assert len(rows) == _GEO_ROWS
    return rows


def precompute_bank_values(scene, wavelengths):
    """Per-launch program values at each lane's fixed wavelengths:
    (color_vals [Pc, N, S], prob_vals [Pp, N] at the hero wavelength, sky
    [1 + D, N, S], leaves). A program that reads the ray has 0 there: the
    kernels run its code (the kProg instantiations; the simple ones
    interpret probability programs of the simple form). On a scene whose
    wavelength-only color (probability) programs are baked into a table
    (scene.bake_bank_tables) the kernels read each lane's value from that
    table, as tracer.eval_color_bank does, and color_vals (prob_vals) is
    [0, N, S] ([0, N]): no per-launch bank. Row 0 of ``sky`` is the sky,
    row 1 + i directional lamp i's color program, which a miss reads
    exactly (tracer.bounce_core). ``leaves`` are the flat values of the
    ray-reading programs' leaves (exprs.KernelPrograms.leaf_values; None on
    a scene that runs the simple instantiations, which read none)."""
    n, s = wavelengths.shape
    dev = wavelengths.device
    lam = exprs.ProgramInputs(wavelength=wavelengths)
    hero = exprs.ProgramInputs(wavelength=wavelengths[:, :1])
    zero = torch.zeros((n, s), device=dev)
    color = [] if scene.color_bank_bakeable is not None else scene.color_programs
    color_vals = torch.stack(
        [zero if p.uses_ray_inputs else p(lam).expand(n, s) for p in color]
    ) if color else torch.zeros((0, n, s), device=dev)
    prob = [] if scene.prob_bank_bakeable is not None else scene.prob_programs
    prob_vals = torch.stack(
        [torch.zeros(n, device=dev) if p.uses_ray_inputs else p(hero).expand(n, 1)[:, 0]
         for p in prob]
    ) if prob else torch.zeros((0, n), device=dev)
    sky = torch.stack([
        zero if p.uses_ray_inputs else p(lam).expand(n, s)
        for p in [scene.sky_program] + [scene.color_programs[c] for _, _, c in
                                        scene.directional_lamps]])
    leaves = scene.dense_pack["programs"].leaf_values(wavelengths) if scene.dense_pack["prog"] else None
    return color_vals.contiguous(), prob_vals.contiguous(), sky.contiguous(), leaves


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _sheet_args(scene, dev):
    """The scene sheet and its row indices, checked: every kernel's first
    arguments."""
    pack = scene.dense_pack["tensors"]
    return [
        _check("sheet", pack["sheet"], torch.float32, pack["sheet"].shape, dev),
        _check("meta", pack["meta"], torch.int32, (len(META_FIELDS),), dev),
    ]


def _scene_args(scene, bank_vals, wavelengths, n, s, dev):
    """The pointer arguments every shading kernel takes first: sheet, meta,
    program code, per-launch program values and the baked program tables
    (null where the scene has none) with the lanes' wavelengths, the
    tables' grid size, their first wavelength and grid steps per nm."""
    f32, i32 = torch.float32, torch.int32
    pack, a = scene.dense_pack["tensors"], scene.arrays
    cvals, pvals = bank_vals[:2]
    n_color = 0 if scene.color_bank_bakeable is not None else len(scene.color_programs)
    n_prob = 0 if scene.prob_bank_bakeable is not None else len(scene.prob_programs)
    tables = [
        _check(name, a[name], f32, (len(progs), a[name].shape[1]), dev) if flags is not None else 0
        for name, flags, progs in (
            ("color_bank", scene.color_bank_bakeable, scene.color_programs),
            ("prob_bank", scene.prob_bank_bakeable, scene.prob_programs))]
    lo, hi = scene.bank_span
    return _sheet_args(scene, dev) + [
        _check("code_op", pack["code_op"], i32, pack["code_op"].shape, dev),
        _check("code_val", pack["code_val"], f32, pack["code_op"].shape, dev),
        _check("code_off", pack["code_off"], i32, pack["code_off"].shape, dev),
        _check("color_vals", cvals, f32, (n_color, n, s), dev) if n_color else 0,
        _check("prob_vals", pvals, f32, (n_prob, n), dev) if n_prob else 0,
        *tables, _check("wavelengths", wavelengths, f32, (n, s), dev),
        BANK_GRID, lo, (BANK_GRID - 1) / (hi - lo),
    ]


def prog_args(scene, bank_vals, n, s, dev):
    """The arguments the kProg instantiations read after the others (every
    instantiation takes them; the rest read none): the code's arguments and
    vector constants, the launch's leaf values, the textures and their
    [T, 4] (offset, height, width, channels) table, the frame and uv tables
    of triangle, sphere and plane hits, the program counts, the program
    stack's depth and the scene's form. On a scene that runs the simple
    instantiations, null pointers and zeros but the form: they read none of
    it."""
    if not scene.dense_pack["prog"]:
        return [0] * 13 + [scene.dense_pack["form"]]
    f32, i32 = torch.float32, torch.int32
    pack, a = scene.dense_pack["tensors"], scene.arrays
    programs = scene.dense_pack["programs"]
    t, sp, pl = a["tri_q"].shape[0], a["sph_texscale"].shape[0], a["pla_quat"].shape[0]
    leaves = bank_vals[3]
    return [
        _check("code_arg", pack["code_arg"], i32, pack["code_op"].shape, dev),
        _check("vecs", pack["vecs"], f32, pack["vecs"].shape, dev),
        _check("leaves", leaves, f32, (max(sum(w for _, w in programs.leaves) * n * s, 1),), dev),
        _check_aligned("tex", pack["tex"], pack["tex"].shape, dev),
        _check("tex_info", pack["tex_info"], i32, pack["tex_info"].shape, dev),
        _check("tri_q", a["tri_q"], f32, (t, 3, 4), dev),
        _check("tri_uv", a["tri_uv"], f32, (t, 3, 2), dev),
        _check("sph_texscale", a["sph_texscale"], f32, (sp, 2), dev),
        _check("pla_quat", a["pla_quat"], f32, (pl, 4), dev),
        _check("pla_texscale", a["pla_texscale"], f32, (pl, 2), dev),
        programs.counts[0], programs.counts[2], scene.dense_pack["stack"], FORM_PROG,
    ]


def _check_aligned(name, t, shape, dev):
    """A float32 table that the kernels read as float4: 16-byte aligned."""
    ptr = _check(name, t, torch.float32, shape, dev)
    if ptr % 16:
        raise ValueError(f"{name}: not 16-byte aligned; the kernels read it as float4")
    return ptr


def check_leaves(scene, dev):
    """The leaf clusters' pointer, checked: the traversal reads each 48-byte
    row of clu_geo as three 16-byte loads."""
    return _check_aligned("clu_geo", scene.arrays["clu_geo"],
                          (scene.cluster_slots, scene.cluster_leaf, 12), dev)


def wide_args(scene, dev):
    """The arguments the mesh-scene kernels take after the shared ones: the
    node table, the leaf clusters, the triangle and sphere tables and the
    leaf size."""
    f32, i32 = torch.float32, torch.int32
    a = scene.arrays
    t, s = a["tri_mat"].shape[0], a["sph_mat"].shape[0]
    leaf = scene.cluster_leaf
    return [
        _check("wide_rows", a["wide_rows"], f32, (273, 128), dev),
        check_leaves(scene, dev),
        _check("tri_n", a["tri_n"], f32, (t, 3, 3), dev),
        _check("tri_mat", a["tri_mat"], i32, (t,), dev),
        _check("sph_center", a["sph_center"], f32, (s, 3), dev),
        _check("sph_mat", a["sph_mat"], i32, (s,), dev),
        leaf,
    ]


def _named(scene, name):
    """``name``, or its kProg instantiation's on a scene that runs those."""
    return prog_name(name) if scene.dense_pack["prog"] else name


def kernel_names(scene):
    """(bounce kernel, NEE kernel) that run ``scene``, as launches counts
    them ("<prog>" for the kProg instantiations)."""
    names = ("wide_bounce_kernel", "wide_nee_kernel") if scene.use_clusters else (
        "dense_bounce_kernel", "dense_nee_kernel")
    return tuple(_named(scene, k) for k in names)


def _with_scene_tables(scene, args, dev):
    """Launch arguments with the mesh tables put before the stream."""
    return args[:-1] + wide_args(scene, dev) + args[-1:] if scene.use_clusters else args


def _with_programs(scene, args, bank_vals, n, s, dev):
    """Launch arguments with prog_args put before the stream."""
    return args[:-1] + prog_args(scene, bank_vals, n, s, dev) + args[-1:]


def _flag(t):
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _device(scene, wavelengths):
    dev = wavelengths.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev}")
    n, s = wavelengths.shape
    if s < 1:
        raise ValueError(f"{s} spectrum samples; the kernels take at least 1")
    return dev, n, s


def _t_de(name, t, shape, dev):
    """A march pass's output, checked, as a kernel argument (0 where the
    scene has no DE shape)."""
    return _check(name, t, torch.float32, shape, dev) if shape[0] else 0


def bounce_kernel_args(scene, cfg, wavelengths, state, draws, bank_vals, t_de=None, record=False,
                       chain=False):
    """Checked arguments of one bounce kernel launch (the scene's, see
    kernel_names), with the outputs it writes: (ctypes arguments, new state,
    NEE context), and with ``record`` the camera vertex
    (tracer.bounce_core's info) that its kRecord instantiation writes after
    them; with ``chain`` also the chain factors of the photon renderer
    (reflected, color_prob [N, S], color_prog, path_prob), which it skips
    where their pointers are null (the bidirectional renderer). ``t_de`` is
    march_pass' output on a scene with DE shapes."""
    dev, n, s = _device(scene, wavelengths)
    f32, u8, i32 = torch.float32, torch.uint8, torch.int32
    out = {
        "origin": torch.empty((n, 3), dtype=f32, device=dev),
        "direction": torch.empty((n, 3), dtype=f32, device=dev),
        "brightness": torch.empty((n, s), dtype=f32, device=dev),
        "reflectance": torch.empty((n, s), dtype=f32, device=dev),
        "alive": torch.empty(n, dtype=torch.bool, device=dev),
        "aux_alive": torch.empty(n, dtype=torch.bool, device=dev),
        "sample_light": torch.empty(n, dtype=torch.bool, device=dev),
        "light_events": torch.empty(n, dtype=i32, device=dev),
    }
    # the bounce kernel hands the NEE kernel the facing normal, the
    # reflectance before the BRDF factor and which lanes take NEE
    ctx = {
        "flip": torch.empty((n, 3), dtype=f32, device=dev),
        "refl_nee": torch.empty((n, s), dtype=f32, device=dev),
        "nee": torch.empty(n, dtype=torch.bool, device=dev),
    }
    args = _scene_args(scene, bank_vals, wavelengths, n, s, dev) + [
        _check("sky", bank_vals[2], f32, (1 + len(scene.directional_lamps), n, s), dev),
        _check("origin", state["origin"], f32, (n, 3), dev),
        _check("direction", state["direction"], f32, (n, 3), dev),
        _check("brightness", state["brightness"], f32, (n, s), dev),
        _check("reflectance", state["reflectance"], f32, (n, s), dev),
        _check("alive", _flag(state["alive"]), u8, (n,), dev),
        _check("aux_alive", _flag(state["aux_alive"]), u8, (n,), dev),
        _check("sample_light", _flag(state["sample_light"]), u8, (n,), dev),
        _check("light_events", state["light_events"], i32, (n,), dev),
        _check("u_comp", draws["u_comp"], f32, (n,), dev),
        _check("u_scatter", draws["u_scatter"], f32, (n, 3), dev),
    ] + [
        out[k].data_ptr() for k in (
            "origin", "direction", "brightness", "reflectance",
            "alive", "aux_alive", "sample_light", "light_events",
        )
    ] + [ctx[k].data_ptr() for k in ("flip", "refl_nee", "nee")] + [
        n, s, cfg.light_samples, len(scene.color_programs), len(scene.de_shapes),
        _t_de("t_de", t_de, (len(scene.de_shapes), n), dev),
        torch.cuda.current_stream(dev).cuda_stream,
    ]
    args = _with_scene_tables(scene, args, dev)
    if not record:
        return _with_programs(scene, args, bank_vals, n, s, dev), out, ctx
    flag = lambda: torch.empty(n, dtype=torch.bool, device=dev)  # noqa: E731
    info = {
        "position": torch.empty((n, 3), dtype=f32, device=dev),
        "normal": torch.empty((n, 3), dtype=f32, device=dev),
        "brdf_stored": torch.empty(n, dtype=f32, device=dev),
        "is_diffuse": flag(), "dispersed": flag(), "recorded": flag(), "miss": flag(),
    }
    if chain:
        info.update(reflected=flag(), color_prob=torch.empty((n, s), dtype=f32, device=dev),
                    color_prog=torch.empty(n, dtype=i32, device=dev),
                    path_prob=torch.empty(n, dtype=f32, device=dev))
    rec = [info[k].data_ptr() for k in (
        "position", "normal", "brdf_stored", "is_diffuse", "dispersed", "recorded", "miss")] + [
        info[k].data_ptr() if chain else 0 for k in ("color_prob", "color_prog", "path_prob",
                                                     "reflected")]
    info["incident"] = state["direction"]
    args = _with_programs(scene, args[:-1] + rec + args[-1:], bank_vals, n, s, dev)
    return args, out, ctx, info


def nee_kernel_args(scene, cfg, wavelengths, out, ctx, draws, bank_vals, t_de_shadow=None):
    """Checked arguments of one NEE kernel launch (the scene's, see
    kernel_names), which adds the light samples' contributions into
    ``out["brightness"]`` in place. ``t_de_shadow`` is shadow_pass' output
    on a scene with DE shapes."""
    dev, n, s = _device(scene, wavelengths)
    f32, u8, i32 = torch.float32, torch.uint8, torch.int32
    ls = cfg.light_samples
    args = _scene_args(scene, bank_vals, wavelengths, n, s, dev) + [
        _check("position", out["origin"], f32, (n, 3), dev),
        _check("flip", ctx["flip"], f32, (n, 3), dev),
        _check("nee", _flag(ctx["nee"]), u8, (n,), dev),
        _check("aux_alive", _flag(out["aux_alive"]), u8, (n,), dev),
        _check("refl_nee", ctx["refl_nee"], f32, (n, s), dev),
        _check("lamp_idx", draws["lamp_idx"], i32, (n,), dev),
        _check("u_nee", draws["u_nee"], f32, (ls, n, 4), dev),
        _check("u_emis", draws["u_emis"], f32, (ls, n), dev),
        _check("brightness", out["brightness"], f32, (n, s), dev),
        n, s, ls, len(scene.color_programs),
        1.0 / (ls * 2.0 * math.pi * (1.0 / scene.num_lamps)), len(scene.de_shapes),
        _t_de("t_de_shadow", t_de_shadow, (len(scene.de_shapes), ls, n), dev),
        torch.cuda.current_stream(dev).cuda_stream,
    ]
    return _with_programs(scene, _with_scene_tables(scene, args, dev), bank_vals, n, s, dev)


def _launch(name, args):
    """Launch kernel ``name`` with its checked ctypes arguments, or raise."""
    from . import _build

    rc = getattr(_build.load(), _LAUNCHERS[name])(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


def record_name(scene):
    """The name launches counts the scene's kRecord bounce under."""
    return _named(scene, ("wide" if scene.use_clusters else "dense") + "_bounce_kernel<record>")


def launch_bounce_kernel(scene, cfg, wavelengths, state, draws, bank_vals, t_de=None,
                         record=False, chain=False):
    """One launch of the scene's bounce kernel: (new state without the NEE
    contribution, NEE context); with ``record``, of its kRecord
    instantiation: (new state, NEE context, camera vertex, with the chain
    factors where ``chain``)."""
    args, out, ctx, *info = bounce_kernel_args(
        scene, cfg, wavelengths, state, draws, bank_vals, t_de, record, chain)
    _launch(record_name(scene) if record else kernel_names(scene)[0], args)
    return (out, ctx, *info)


def launch_nee_kernel(scene, cfg, wavelengths, out, ctx, draws, bank_vals, t_de_shadow=None):
    """One launch of the scene's NEE kernel, accumulating into
    out["brightness"]."""
    _launch(kernel_names(scene)[1],
            nee_kernel_args(scene, cfg, wavelengths, out, ctx, draws, bank_vals, t_de_shadow))


def _pass_device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the march passes run on CPU or CUDA tensors, not {dev}")
    return dev


def check_rays(rays, what):
    """A march pass marches at most INT_MAX rays per DE shape (its items,
    shapes x rays, and its work counter are 64-bit; a ray index is an int)."""
    if rays > INT_MAX:
        raise ValueError(f"{what}: {rays} rays per DE shape, more than the march passes take "
                         f"(INT_MAX = {INT_MAX})")


def _pass_output(shape, dev):
    """A march pass's t, and the address of its work counter: 8 bytes after
    t in the same buffer, 8-byte aligned, so it lives as long as t does (the
    launcher zeroes it on the stream before each launch)."""
    size = math.prod(shape)
    at = size + (size & 1)
    buf = torch.empty(at + 2, dtype=torch.float32, device=dev)
    return buf[:size].view(shape), buf[at:].view(torch.int64).data_ptr()


def march_pass_args(scene, cfg, state):
    """Checked arguments of one march pass over the bounce rays of
    ``state``, with the t it writes: (ctypes arguments, t_de [n_de, N])."""
    o, d, alive = state["origin"], state["direction"], state["alive"]
    dev, f32, n, n_de = o.device, torch.float32, o.shape[0], len(scene.de_shapes)
    t_de, next_item = _pass_output((n_de, n), dev)
    return _sheet_args(scene, dev) + [
        _check("origin", o, f32, (n, 3), dev),
        _check("direction", d, f32, (n, 3), dev),
        _check("alive", _flag(alive), torch.uint8, (n,), dev),
        t_de.data_ptr(), n, n_de, cfg.max_de_steps, tracer.DE_OMEGA, next_item,
        torch.cuda.current_stream(dev).cuda_stream,
    ], t_de


def march_pass(scene, cfg, state):
    """t of each DE shape along each alive lane's ray, [n_de, N] f32:
    tracer.intersect_de's t, inf where the ray misses the shape or the lane
    is dead (tracer.de_hits on the CPU; march_de_kernel over the bounce rays
    on a GPU). The bounce kernel takes it after the primitives."""
    dev = _pass_device(state["origin"])
    check_rays(state["origin"].shape[0], "march_pass")
    if dev.type == "cpu":
        return tracer.de_hits(scene, state["origin"], state["direction"], cfg.max_de_steps,
                              live=state["alive"])
    args, t_de = march_pass_args(scene, cfg, state)
    _launch("de_march_pass", args)
    return t_de


def shadow_rays(scene, out, ctx, draws, sample):
    """The shadow rays that the NEE lanes cast at light sample ``sample``,
    as nee_lane casts them: (direction [N, 3], lamp distance [N], cast [N]),
    cast where the lane takes NEE and the lamp sample lies in front of its
    surface. They start at out["origin"]."""
    samp = tracer.sample_lamp(scene, draws["lamp_idx"].long(), out["origin"], draws["u_nee"][sample])
    cast = ctx["nee"] & (torch.clamp(geom.dot(ctx["flip"], samp["direction"]), min=0.0) > 0.0)
    return samp["direction"], torch.sqrt(samp["sq_distance"]), cast


def shadow_pass_plain(scene, cfg, out, ctx, draws):
    """The plain version of shadow_pass, on any device: tracer.de_hits on
    each light sample's shadow_rays."""
    rows = []
    for j in range(cfg.light_samples):
        d, dist, cast = shadow_rays(scene, out, ctx, draws, j)
        rows.append(tracer.de_hits(scene, out["origin"], d, cfg.max_de_steps, t_cap=dist, live=cast))
    return torch.stack(rows, dim=1)


def shadow_pass_args(scene, cfg, out, ctx, draws):
    """Checked arguments of one shadow march pass, with the t it writes:
    (ctypes arguments, t_de_shadow [n_de, light_samples, N])."""
    dev, f32 = out["origin"].device, torch.float32
    n, n_de, ls = out["origin"].shape[0], len(scene.de_shapes), cfg.light_samples
    t_de, next_item = _pass_output((n_de, ls, n), dev)
    return _sheet_args(scene, dev) + [
        _check("position", out["origin"], f32, (n, 3), dev),
        _check("flip", ctx["flip"], f32, (n, 3), dev),
        _check("nee", _flag(ctx["nee"]), torch.uint8, (n,), dev),
        _check("lamp_idx", draws["lamp_idx"], torch.int32, (n,), dev),
        _check("u_nee", draws["u_nee"], f32, (ls, n, 4), dev),
        t_de.data_ptr(), n, ls, n_de, cfg.max_de_steps, tracer.DE_OMEGA, next_item,
        torch.cuda.current_stream(dev).cuda_stream,
    ], t_de


def shadow_pass(scene, cfg, out, ctx, draws):
    """t of each DE shape along each shadow ray of the bounce's NEE lanes,
    [n_de, light_samples, N] f32: tracer.intersect_de's t marched no further
    than the lamp, inf where the ray misses the shape or is not cast
    (shadow_pass_plain on the CPU; march_de_kernel over the shadow rays on a
    GPU, which samples the lamps again from the same draws). The NEE kernel
    takes it after the primitives."""
    dev = _pass_device(out["origin"])
    check_rays(cfg.light_samples * out["origin"].shape[0], "shadow_pass (light samples x lanes)")
    if dev.type == "cpu":
        return shadow_pass_plain(scene, cfg, out, ctx, draws)
    args, t_de = shadow_pass_args(scene, cfg, out, ctx, draws)
    _launch("de_shadow_pass", args)
    return t_de


def bounce_dense(scene, cfg, wavelengths, state, draws, bank_vals, record=False, chain=False):
    """One bounce, a drop-in for tracer.bounce_core: the plain version for
    tensors on the CPU, the scene's two CUDA kernels (dense or wide, see
    kernel_names; after march_pass and shadow_pass respectively on a scene
    with DE shapes) for tensors on a GPU, or an error. ``bank_vals`` is
    precompute_bank_values' output. With ``record`` (the bidirectional and
    photon renderers' camera walks) it returns (new state, camera vertex)
    as bounce_core does, through the bounce kernel's kRecord instantiation,
    which writes the chain factors of the vertex only where ``chain`` (the
    photon renderer; bounce_core returns them always)."""
    dev = wavelengths.device
    if dev.type == "cpu":
        return tracer.bounce_core(scene, cfg, wavelengths, state, draws, record)
    if dev.type != "cuda":
        raise ValueError(f"bounce_dense runs on CPU or CUDA tensors, not {dev}")
    de = bool(scene.de_shapes)
    t_de = march_pass(scene, cfg, state) if de else None
    out, ctx, *info = launch_bounce_kernel(
        scene, cfg, wavelengths, state, draws, bank_vals, t_de, record, chain)
    if scene.num_lamps and cfg.light_samples:
        t_de_shadow = shadow_pass(scene, cfg, out, ctx, draws) if de else None
        launch_nee_kernel(scene, cfg, wavelengths, out, ctx, draws, bank_vals, t_de_shadow)
    return (out, info[0]) if record else out


# --- the bidirectional renderer's lamp walk and shadow queries ----------------


def _cuda(t, what):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {dev}")
    return dev


def lamp_kernel_args(scene, wavelengths, words, bank_vals, state=None, t_de=None):
    """Checked arguments of one lamp kernel launch, with the outputs it
    writes: (ctypes arguments, vertex, next state). ``state`` None launches
    the start mode (``words`` the LAMP_START words [N, 6]), else one bounce
    of ``state`` (``words`` the LAMP_BOUNCE words [N, 4]); ``t_de`` is
    march_pass' output on a scene with DE shapes."""
    dev, n, s = _device(scene, wavelengths)
    f32, u8, i32 = torch.float32, torch.uint8, torch.int32
    start = state is None
    flag = lambda: torch.empty(n, dtype=torch.bool, device=dev)  # noqa: E731
    vertex = {
        "position": torch.empty((n, 3), dtype=f32, device=dev),
        "normal": torch.empty((n, 3), dtype=f32, device=dev),
        "uv": torch.zeros((n, 2), dtype=f32, device=dev),
        "color_prog": torch.empty(n, dtype=i32, device=dev),
        "probability": torch.empty(n, dtype=f32, device=dev),
        "is_diffuse": flag(), "dispersed": flag(), "valid": flag(),
        "brdf": torch.empty(n, dtype=f32, device=dev),
        "brdf_scatter": torch.empty(n, dtype=f32, device=dev),
    }
    nxt = {"origin": torch.empty((n, 3), dtype=f32, device=dev),
           "direction": torch.empty((n, 3), dtype=f32, device=dev), "alive": flag()}
    if start:
        rays = [0, 0, 0]
    else:
        rays = [_check("origin", state["origin"], f32, (n, 3), dev),
                _check("direction", state["direction"], f32, (n, 3), dev),
                _check("alive", _flag(state["alive"]), u8, (n,), dev)]
    args = _scene_args(scene, bank_vals, wavelengths, n, s, dev) + [*rays,
        _check("words", words, f32, (n, 6 if start else 4), dev),
    ] + [vertex[k].data_ptr() for k in (
        "position", "normal", "uv", "color_prog", "probability", "is_diffuse", "dispersed",
        "valid", "brdf", "brdf_scatter")] + [
        nxt[k].data_ptr() for k in ("origin", "direction", "alive")] + [
        n, s, scene.num_lamps, int(start), len(scene.color_programs), len(scene.de_shapes),
        0 if start else _t_de("t_de", t_de, (len(scene.de_shapes), n), dev),
        torch.cuda.current_stream(dev).cuda_stream,
    ]
    args = _with_programs(scene, _with_scene_tables(scene, args, dev), bank_vals, n, s, dev)
    return args, vertex, nxt


def _lamp_name(scene):
    return _named(scene, "wide_lamp_kernel" if scene.use_clusters else "dense_lamp_kernel")


def lamp_start(scene, wavelengths, draws, bank_vals=None):
    """The emitter vertex of each lamp path and the walk's first state, a
    drop-in for tracer.lamp_start: the plain version for tensors on the
    CPU, the lamp kernel's start mode on a GPU (from draws["words"], the
    LAMP_START words), or an error."""
    dev = _cuda(wavelengths, "lamp_start")
    if dev.type == "cpu":
        return tracer.lamp_start(scene, wavelengths, draws)
    if "words" not in draws:
        raise ValueError("lamp_start on the card takes rng.lamp_start_draws' words")
    args, vertex, nxt = lamp_kernel_args(scene, wavelengths, draws["words"], bank_vals)
    _launch(_lamp_name(scene), args)
    del vertex["brdf_scatter"]  # a bounce's alone
    return vertex, nxt


def lamp_bounce(scene, cfg, wavelengths, state, draws, bank_vals=None):
    """One lamp bounce, a drop-in for tracer.lamp_bounce_step: the plain
    version for tensors on the CPU, the lamp kernel (after march_pass on a
    scene with DE shapes) on a GPU, or an error. Returns (next state,
    vertex)."""
    dev = _cuda(wavelengths, "lamp_bounce")
    if dev.type == "cpu":
        return tracer.lamp_bounce_step(scene, cfg, wavelengths, state, draws)
    if "words" not in draws:
        raise ValueError("lamp_bounce on the card takes rng.lamp_bounce_draws' words")
    t_de = march_pass(scene, cfg, state) if scene.de_shapes else None
    args, vertex, nxt = lamp_kernel_args(scene, wavelengths, draws["words"], bank_vals, state, t_de)
    _launch(_lamp_name(scene), args)
    return nxt, vertex


def shadow_query_plain(scene, cfg, origin, direction, max_dist, block_below, live):
    """The plain version of shadow_query, on any device:
    tracer.intersect_shadow on the live rays, max_dist on the others."""
    t = max_dist.clone()
    lanes = torch.nonzero(live)[:, 0]
    if lanes.numel():
        t[lanes] = tracer.intersect_shadow(
            scene, origin[lanes], direction[lanes], max_dist[lanes], block_below[lanes],
            cfg.max_de_steps)
    return t


def query_pass_args(scene, cfg, origin, direction, max_dist, live):
    """Checked arguments of one query march pass over a shadow batch, with
    the t it writes: (ctypes arguments, t_de [n_de, M])."""
    dev, f32, m, n_de = origin.device, torch.float32, origin.shape[0], len(scene.de_shapes)
    t_de, next_item = _pass_output((n_de, m), dev)
    return _sheet_args(scene, dev) + [
        _check("origin", origin, f32, (m, 3), dev),
        _check("direction", direction, f32, (m, 3), dev),
        _check("max_dist", max_dist, f32, (m,), dev),
        _check("live", _flag(live), torch.uint8, (m,), dev),
        t_de.data_ptr(), m, n_de, cfg.max_de_steps, tracer.DE_OMEGA, next_item,
        torch.cuda.current_stream(dev).cuda_stream,
    ], t_de


def dense_shadow_args(scene, origin, direction, max_dist, block_below, live, t_de=None):
    """Checked arguments of one dense_shadow_kernel launch, with the t it
    writes: (ctypes arguments, t [M])."""
    dev, f32, m = origin.device, torch.float32, origin.shape[0]
    t = torch.empty(m, dtype=f32, device=dev)
    return _sheet_args(scene, dev) + [
        _check("origin", origin, f32, (m, 3), dev),
        _check("direction", direction, f32, (m, 3), dev),
        _check("max_dist", max_dist, f32, (m,), dev),
        _check("block_below", block_below, f32, (m,), dev),
        _check("live", _flag(live), torch.uint8, (m,), dev),
        t.data_ptr(), m, len(scene.de_shapes),
        _t_de("t_de", t_de, (len(scene.de_shapes), m), dev),
        torch.cuda.current_stream(dev).cuda_stream,
    ], t


def shadow_query(scene, cfg, origin, direction, max_dist, block_below, live):
    """Nearest occluder along each shadow ray of a batch ([M, 3] origins
    and directions, [M] lamp distances, occlusion bounds and ``live``
    flags), from max_dist, as tracer.intersect_shadow: t [M], max_dist where
    unoccluded or not live (such a ray is not traced). The plain version
    (shadow_query_plain) for tensors on the CPU; on a GPU, dense_shadow_kernel
    on a dense scene, wide_shadow_kernel (kernels.shadow_wide) on a mesh
    scene, and on a scene with DE shapes a query march pass over the live
    rays first, whose t count at any t (tracer.py:492-496)."""
    dev = _cuda(origin, "shadow_query")
    m = origin.shape[0]
    check_rays(m, "shadow_query")
    if dev.type == "cpu":
        return shadow_query_plain(scene, cfg, origin, direction, max_dist, block_below, live)
    t_de = None
    if scene.de_shapes:
        args, t_de = query_pass_args(scene, cfg, origin, direction, max_dist, live)
        _launch("de_query_pass", args)
    if not scene.use_clusters:
        args, t = dense_shadow_args(scene, origin, direction, max_dist, block_below, live, t_de)
        _launch("dense_shadow_kernel", args)
        return t
    from . import kernels

    # rays that are not live start at t = 0: the root box rejects them
    t = kernels.launch_shadow_wide(scene, origin, direction, torch.where(live, max_dist, 0.0),
                                   torch.where(live, block_below, 0.0))
    for j in range(len(scene.de_shapes)):
        t = torch.minimum(t, t_de[j])
    return torch.where(live, t, max_dist)


# --- the lamp vertices' colors -----------------------------------------------


def vertex_colors_plain(scene, color_prog, valid, normal, incident, uv, wavelengths):
    """The plain version of vertex_colors, on any device:
    tracer.eval_color_bank on the flattened [N K] vertices (``normal``,
    ``incident`` and ``uv`` None where no program reads the ray)."""
    n, slots = color_prog.shape
    s = wavelengths.shape[1]
    flat = lambda x: None if x is None else x.reshape((n * slots,) + x.shape[2:])  # noqa: E731
    inputs = exprs.ProgramInputs(
        wavelength=wavelengths[:, None, :].expand(n, slots, s).reshape(n * slots, s),
        normal=flat(normal), incident=flat(incident), uv=flat(uv))
    return tracer.eval_color_bank(scene, flat(color_prog).long(), inputs,
                                  active=flat(valid)).reshape(n, slots, s)


def vertex_colors_args(scene, color_prog, valid, normal, incident, uv, wavelengths, bank_vals):
    """Checked arguments of one program_colors_kernel launch, with the
    colors it writes: (ctypes arguments, out [N, K, S])."""
    dev, n, s = _device(scene, wavelengths)
    slots = color_prog.shape[1]
    f32 = torch.float32
    check_rays(n * slots, "vertex_colors")
    out = torch.empty((n, slots, s), dtype=f32, device=dev)
    args = _scene_args(scene, bank_vals, wavelengths, n, s, dev) + [
        _check("color_prog", color_prog, torch.int32, (n, slots), dev),
        _check("valid", _flag(valid), torch.uint8, (n, slots), dev),
        _check("normal", normal, f32, (n, slots, 3), dev),
        _check("incident", incident, f32, (n, slots, 3), dev),
        _check("uv", uv, f32, (n, slots, 2), dev),
        out.data_ptr(), n, slots, s, len(scene.color_programs),
        torch.cuda.current_stream(dev).cuda_stream,
    ]
    return _with_programs(scene, args, bank_vals, n, s, dev), out


def vertex_colors(scene, color_prog, valid, normal, incident, uv, wavelengths, bank_vals):
    """Each lamp vertex's color program at its lane's wavelengths, [N, K,
    S], from its uv, normal and incident direction ([N, K] programs and
    valid flags, [N, K, 3] vectors, [N, K, 2] uv): tracer.eval_color_bank's
    values, 0 where the program is out of range or the vertex not valid.
    The plain version (vertex_colors_plain) for tensors on the CPU; on a
    GPU, program_colors_kernel, which reads the programs that read no ray
    from ``bank_vals`` and runs the others' code (csrc/bounce.cu)."""
    dev = _cuda(wavelengths, "vertex_colors")
    if dev.type == "cpu":
        return vertex_colors_plain(scene, color_prog, valid, normal, incident, uv, wavelengths)
    args, out = vertex_colors_args(scene, color_prog, valid, normal, incident, uv, wavelengths,
                                   bank_vals)
    _launch("program_colors_kernel", args)
    return out


# --- the photon renderer's radius gather ---------------------------------------

GATHER_WARPS = 4  # csrc/photon.cu GATHER_WARPS: warps a block of photon_gather_kernel


FRESH_CHUNK = 64  # csrc/photon.cu FRESH_CHUNK: fresh wavelengths a warp's row holds


def gather_smem_bytes(bins, k, out_row=False):
    """photon_gather_kernel's dynamic shared memory a block, as its launcher
    passes it (csrc/photon.cu gather_row): each warp's row of its vertex's
    B acc bins and B cnt bins (none in the <out_row> form, which keeps them
    in the warp's output row), K fresh sums (none past FRESH_CHUNK: the
    output row's), a batch of 32 pairs' fresh values of a chunk of kc =
    min(K, FRESH_CHUNK) wavelengths at a stride of kc | 1 and a ring of 64
    pairs' photon indices, [GATHER_WARPS, 2 B + (K or 0) + 32 (kc | 1) +
    64] 4-byte words: flat in K past FRESH_CHUNK, and in B in the
    <out_row> form."""
    kc = min(k, FRESH_CHUNK)
    row_bins = 0 if out_row else bins
    return 4 * GATHER_WARPS * (2 * row_bins + (k if k <= FRESH_CHUNK else 0) + 32 * (kc | 1) + 64)


def gather_out_row(bins, k):
    """Whether photon_gather_kernel keeps a vertex's bins in its output row
    (the <out_row> form), where its row form's shared memory
    (gather_smem_bytes) passes what a block holds: past 7,085 bins at K =
    6. Both forms make the same adds in the same order."""
    return gather_smem_bytes(bins, k) > SMEM_PER_BLOCK


def photon_gather_args(spec, pm, q, out_row=None):
    """Checked arguments of one photon_gather_kernel launch, with the
    outputs it writes: (ctypes arguments, {acc_bins, cnt_bins,
    num_neighbors, fresh_psum, fresh_cnt}). ``spec`` is a
    renderers.photon.GatherSpec, ``pm`` a photon map (build_map) and ``q``
    one camera bounce's query (gather_query); ``out_row`` picks the
    kernel's form (gather_out_row's by default)."""
    dev = q["position"].device
    if dev.type != "cuda":
        raise ValueError(f"photon_gather_kernel takes CUDA tensors, not {dev}")
    f32, u8, i32 = torch.float32, torch.uint8, torch.int32
    n, p = q["position"].shape[0], pm["keys"].shape[0]
    k, b, s, g = spec.spectrum_samples, spec.bins, spec.spectrum_samples, spec.g_bins
    m = pm["log_f"].shape[1] if spec.exact else 0
    check_rays(n, "photon_gather")
    check_rays(p, "photon_gather (photons)")
    cols = q["partialR"].shape[1]
    if cols < s + g or pm["power"].shape[1] != spec.power_cols:
        raise ValueError(f"photon_gather: partialR of {cols} columns, power of "
                         f"{pm['power'].shape[1]}; expected >= {s + g} and {spec.power_cols}")
    out = {
        "acc_bins": torch.empty((n, b), dtype=f32, device=dev),
        "cnt_bins": torch.empty((n, b), dtype=f32, device=dev),
        "num_neighbors": torch.empty(n, dtype=i32, device=dev),
        "fresh_psum": torch.empty((n, k), dtype=f32, device=dev),
        "fresh_cnt": torch.empty(n, dtype=i32, device=dev),
    }
    exact = (lambda name, t, shape: _check(name, t, f32, shape, dev)) if spec.exact else (
        lambda name, t, shape: 0)
    lo, hi = spec.span
    args = [
        _check("keys", pm["keys"], i32, (p,), dev),
        _check("p_position", pm["position"], f32, (p, 3), dev),
        _check("p_valid", _flag(pm["valid"]), u8, (p,), dev),
        _check("p_incident", pm["incident"], f32, (p, 3), dev),
        _check("p_power", pm["power"], f32, (p, spec.power_cols), dev),
        _check("p_wavelength", pm["wavelength"], f32, (p,), dev),
        _check("p_dispersed", _flag(pm["dispersed"]), u8, (p,), dev),
        exact("p_counts", pm.get("counts"), (p, m)), exact("p_scalar", pm.get("scalar"), (p,)),
        exact("p_log_f", pm.get("log_f"), (p, m)), exact("p_neg_f", pm.get("neg_f"), (p, m)),
        exact("p_zero_f", pm.get("zero_f"), (p, m)),
        _check("q_position", q["position"], f32, (n, 3), dev),
        _check("q_normal", q["normal"], f32, (n, 3), dev),
        _check("q_incident", q["incident"], f32, (n, 3), dev),
        _check("q_valid", _flag(q["valid"]), u8, (n,), dev),
        _check("q_dispersed", _flag(q["dispersed"]), u8, (n,), dev),
        _check("partialR", q["partialR"], f32, (n, cols), dev),
        _check("lam0", q["lam0"], f32, (n,), dev),
        _check("lam_f", q["lam_f"], f32, (n, k), dev),
        exact("q_counts", q.get("counts"), (n, m)), exact("q_scalar", q.get("scalar"), (n,)),
        exact("log_f0", q.get("log_f0"), (n, m)), exact("neg_f0", q.get("neg_f0"), (n, m)),
        exact("zero_f0", q.get("zero_f0"), (n, m)),
        exact("log_ff", q.get("log_ff"), (n, k, m)), exact("neg_ff", q.get("neg_ff"), (n, k, m)),
        exact("zero_ff", q.get("zero_ff"), (n, k, m)),
    ] + [out[key].data_ptr() for key in (
        "acc_bins", "cnt_bins", "num_neighbors", "fresh_psum", "fresh_cnt")] + [
        n, p, m, k, b, cols, s, g, int(spec.exact), spec.power_cols,
        int(gather_out_row(b, k) if out_row is None else out_row), spec.radius,
        spec.radius * spec.radius, lo, b / (hi - lo), (hi - lo) / b,
        (hi - lo) / g if g else 1.0, torch.cuda.current_stream(dev).cuda_stream,
    ]
    return args, out


def photon_gather(spec, pm, q):
    """The radius gather of one camera bounce against one photon map
    (pyrite_tpu/renderers/photon.py:391-468): per camera vertex, the photons
    of the 27 neighbour cells within the radius, binned (acc_bins, cnt_bins
    [N, B]), counted (num_neighbors), and their fresh sums (fresh_psum [N,
    K], fresh_cnt). The plain version (renderers.photon.gather_plain) for
    tensors on the CPU; photon_gather_kernel (csrc/photon.cu) for tensors
    on a GPU, or an error."""
    dev = q["position"].device
    if dev.type == "cpu":
        from .renderers.photon import gather_plain

        return gather_plain(spec, pm, q)
    args, out = photon_gather_args(spec, pm, q)
    out_row = gather_out_row(spec.bins, spec.spectrum_samples)
    _launch("photon_gather_kernel<out_row>" if out_row else "photon_gather_kernel", args)
    return out
