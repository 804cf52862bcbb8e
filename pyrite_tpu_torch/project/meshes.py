"""Wavefront OBJ loading.

Produces flat numpy arrays per named object; only triangle faces are kept
(the reference silently skips non-triangle polygons, world.rs:216-233).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class ObjObject:
    name: str
    # [T, 3] int indices into the shared position/texcoord/normal pools;
    # -1 where a texcoord/normal is absent.
    faces_v: np.ndarray
    faces_vt: np.ndarray
    faces_vn: np.ndarray


@dataclass
class ObjMesh:
    positions: np.ndarray  # [V, 3]
    texcoords: np.ndarray  # [VT, 2]
    normals: np.ndarray  # [VN, 3]
    objects: list


def _parse_index(token: str, count: int) -> int:
    if not token:
        return -1
    idx = int(token)
    return idx - 1 if idx > 0 else count + idx


def load_obj(path: str) -> ObjMesh:
    positions: list = []
    texcoords: list = []
    normals: list = []
    objects: list[ObjObject] = []
    current_faces: list = []
    current_name = "default"

    def flush():
        nonlocal current_faces
        if current_faces:
            arr = np.asarray(current_faces, np.int64).reshape(-1, 3, 3)
            objects.append(
                ObjObject(
                    name=current_name,
                    faces_v=arr[:, :, 0].copy(),
                    faces_vt=arr[:, :, 1].copy(),
                    faces_vn=arr[:, :, 2].copy(),
                )
            )
            current_faces = []

    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                texcoords.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag in ("o", "g"):
                flush()
                current_name = parts[1] if len(parts) > 1 else "default"
            elif tag == "f":
                if len(parts) != 4:
                    continue  # reference keeps only triangles
                face = []
                for vert in parts[1:4]:
                    comps = vert.split("/")
                    v = _parse_index(comps[0], len(positions))
                    vt = _parse_index(comps[1] if len(comps) > 1 else "", len(texcoords))
                    vn = _parse_index(comps[2] if len(comps) > 2 else "", len(normals))
                    face.append([v, vt, vn])
                current_faces.append(face)
    flush()

    return ObjMesh(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, np.float32).reshape(-1, 2),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        objects=objects,
    )


class MeshLoader:
    """Dedup-by-path OBJ registry (reference: project/meshes.rs)."""

    def __init__(self, project_dir: str):
        self.project_dir = project_dir
        self._cache: dict[str, ObjMesh] = {}

    def load(self, rel_path: str) -> ObjMesh:
        path = os.path.realpath(os.path.join(self.project_dir, rel_path))
        if path not in self._cache:
            mesh = None
            try:  # native C++ parser; falls back to the Python one
                from .. import native

                mesh = native.load_obj(path)
            except Exception:
                mesh = None
            self._cache[path] = mesh if mesh is not None else load_obj(path)
        return self._cache[path]
