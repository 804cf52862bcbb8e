"""Top-level project loading (reference: project/mod.rs load_project)."""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..lua.interpreter import Interpreter, LuaTable, LuaError
from .dsl import install_dsl
from .ir import IrBuilder, Project
from .meshes import MeshLoader
from .textures import TextureLoader


@dataclass
class ProjectData:
    project: Project
    meshes: MeshLoader
    textures: TextureLoader
    project_dir: str


def load_project(path: str) -> ProjectData:
    project_dir = os.path.dirname(os.path.abspath(path))

    def loader(name: str):
        # package.path is "<project_dir>/?.lua;..." in the reference
        candidate = os.path.join(project_dir, name.replace(".", os.sep) + ".lua")
        if os.path.exists(candidate):
            with open(candidate) as fh:
                return fh.read()
        return None

    interp = Interpreter(loader=loader)
    install_dsl(interp)

    with open(path) as fh:
        src = fh.read()

    values = interp.run(src, chunk_name=os.path.basename(path))
    if not values or not isinstance(values[0], LuaTable):
        raise LuaError("the project file must return a table")

    builder = IrBuilder()
    project = builder.project(values[0])

    return ProjectData(
        project=project,
        meshes=MeshLoader(project_dir),
        textures=TextureLoader(project_dir),
        project_dir=project_dir,
    )
