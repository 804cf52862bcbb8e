"""ctypes bindings for the native (C++) scene-building kernels.

The library is compiled on first use with g++ if the shared object is absent;
callers fall back to the pure-Python implementations when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(os.path.dirname(_DIR), "_build", "libscene.so")
_SRC = os.path.join(_DIR, "scene_build.cpp")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        try:
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _SO, _SRC],
                check=True,
                capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.pyrite_build_bvh.restype = ctypes.c_int32
    lib.pyrite_build_bvh.argtypes = [f32p, f32p, ctypes.c_int32, f32p, f32p, i32p, i32p]

    lib.pyrite_obj_load.restype = ctypes.c_void_p
    lib.pyrite_obj_load.argtypes = [ctypes.c_char_p]
    lib.pyrite_obj_counts.argtypes = [ctypes.c_void_p, i64p]
    lib.pyrite_obj_vertices.argtypes = [ctypes.c_void_p, f32p, f32p, f32p]
    lib.pyrite_obj_group_info.restype = ctypes.c_int64
    lib.pyrite_obj_group_info.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.pyrite_obj_group_faces.argtypes = [ctypes.c_void_p, ctypes.c_int64, i64p]
    lib.pyrite_obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray):
    """Native binned-SAH build; returns (bbox_min, bbox_max, subtree, prim)
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    count = len(prim_min)
    cap = max(2 * count - 1, 1)
    bbox_min = np.empty((cap, 3), np.float32)
    bbox_max = np.empty((cap, 3), np.float32)
    subtree = np.empty(cap, np.int32)
    prim = np.empty(cap, np.int32)
    nodes = lib.pyrite_build_bvh(
        np.ascontiguousarray(prim_min, np.float32),
        np.ascontiguousarray(prim_max, np.float32),
        count,
        bbox_min,
        bbox_max,
        subtree,
        prim,
    )
    if nodes < 0:
        return None
    return bbox_min[:nodes], bbox_max[:nodes], subtree[:nodes], prim[:nodes]


def load_obj(path: str):
    """Native OBJ parse; returns the same structure as meshes.load_obj or
    None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.pyrite_obj_load(path.encode())
    if not handle:
        return None
    try:
        counts = np.zeros(4, np.int64)
        lib.pyrite_obj_counts(handle, counts)
        nv, nt, nn, ngroups = (int(c) for c in counts)
        positions = np.zeros((max(nv, 1), 3), np.float32)
        texcoords = np.zeros((max(nt, 1), 2), np.float32)
        normals = np.zeros((max(nn, 1), 3), np.float32)
        lib.pyrite_obj_vertices(handle, positions, texcoords, normals)

        from ..project.meshes import ObjMesh, ObjObject

        objects = []
        for g in range(ngroups):
            name = ctypes.create_string_buffer(1024)
            tris = lib.pyrite_obj_group_info(handle, g, name, 1024)
            if tris < 0:
                continue
            faces = np.zeros(tris * 9, np.int64)
            lib.pyrite_obj_group_faces(handle, g, faces)
            arr = faces.reshape(tris, 3, 3)
            objects.append(
                ObjObject(
                    name=name.value.decode(),
                    faces_v=arr[:, :, 0].copy(),
                    faces_vt=arr[:, :, 1].copy(),
                    faces_vn=arr[:, :, 2].copy(),
                )
            )
        return ObjMesh(
            positions=positions[:nv].reshape(-1, 3),
            texcoords=texcoords[:nt].reshape(-1, 2),
            normals=normals[:nn].reshape(-1, 3),
            objects=objects,
        )
    finally:
        lib.pyrite_obj_free(handle)


def build_bvh_clustered(prim_min: np.ndarray, prim_max: np.ndarray, leaf_size: int):
    """Clustered SAH build: leaves hold contiguous primitive ranges of up to
    ``leaf_size`` in the returned permutation order.

    Returns (bbox_min, bbox_max, subtree, leaf_start, leaf_count, perm)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "pyrite_build_bvh_clustered"):
        return None
    if not hasattr(lib.pyrite_build_bvh_clustered, "_configured"):
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.pyrite_build_bvh_clustered.restype = ctypes.c_int32
        lib.pyrite_build_bvh_clustered.argtypes = [
            f32p, f32p, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p, i32p,
        ]
        lib.pyrite_build_bvh_clustered._configured = True
    count = len(prim_min)
    cap = max(2 * count - 1, 1)
    bbox_min = np.empty((cap, 3), np.float32)
    bbox_max = np.empty((cap, 3), np.float32)
    subtree = np.empty(cap, np.int32)
    leaf_start = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    perm = np.empty(count, np.int32)
    nodes = lib.pyrite_build_bvh_clustered(
        np.ascontiguousarray(prim_min, np.float32),
        np.ascontiguousarray(prim_max, np.float32),
        count, leaf_size,
        bbox_min, bbox_max, subtree, leaf_start, leaf_count, perm,
    )
    if nodes <= 0:
        return None
    return (
        bbox_min[:nodes], bbox_max[:nodes], subtree[:nodes],
        leaf_start[:nodes], leaf_count[:nodes], perm,
    )
