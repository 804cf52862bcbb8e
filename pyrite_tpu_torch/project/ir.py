"""Typed scene IR, mirroring the reference's config structs.

The Lua front end returns a tree of tagged tables; this module converts it
into plain Python dataclasses (reference: the typed_nodes-derived structs in
pyrite/src/project/mod.rs:103-252, expressions.rs:65-201,
materials.rs:7-36). Shared tables (from ``:clone``-free reuse) dedupe to
shared IR nodes by table identity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from ..lua.interpreter import LuaTable, LuaError


class ProjectError(LuaError):
    pass


# --- expressions ------------------------------------------------------------

Expression = Union[float, "ComplexExpression"]


@dataclass(eq=False)
class ComplexExpression:
    kind: str  # vector | rgb | binary | mix | clamp | fresnel | blackbody |
    #            spectrum | color_texture | mono_texture
    fields: dict = field(default_factory=dict)


@dataclass(eq=False)
class SpectrumIR:
    """format=array: uniform grid; format=curve: (x, y) points."""

    format: str
    min: float = 0.0
    max: float = 0.0
    points: object = None
    builtin: Optional[str] = None


# --- materials ---------------------------------------------------------------


@dataclass(eq=False)
class MaterialNode:
    kind: str  # emissive | diffuse | mirror | refractive | mix | binary
    fields: dict = field(default_factory=dict)


@dataclass(eq=False)
class Material:
    surface: MaterialNode
    normal_map: Optional[Expression] = None


# --- transforms / camera ------------------------------------------------------


@dataclass(eq=False)
class LookAt:
    from_: Expression
    to: Expression
    up: Optional[Expression] = None


@dataclass(eq=False)
class Camera:
    kind: str  # perspective
    transform: LookAt
    fov: Expression
    focus_distance: Optional[Expression] = None
    aperture: Optional[Expression] = None


# --- renderer ------------------------------------------------------------------


@dataclass(eq=False)
class RendererSettings:
    algorithm: str  # simple | bidirectional | photon_mapping
    pixel_samples: int
    threads: Optional[int] = None
    bounces: int = 8
    light_samples: int = 4
    spectrum_samples: int = 10
    spectrum_bins: int = 64
    spectrum_span: tuple = (380.0, 780.0)
    tile_size: int = 32
    # bidirectional
    light_bounces: int = 8
    # photon mapping
    radius: float = 0.1
    photon_bounces: int = 8
    photons: int = 10000
    photon_passes: int = 1


# --- world objects ---------------------------------------------------------------


@dataclass(eq=False)
class Sphere:
    position: Expression
    radius: Expression
    material: Material
    texture_scale: Optional[Expression] = None


@dataclass(eq=False)
class Plane:
    origin: Expression
    normal: Expression
    material: Material
    texture_scale: Optional[Expression] = None


@dataclass(eq=False)
class BoundingBox:
    min: Expression
    max: Expression


@dataclass(eq=False)
class BoundingSphere:
    position: Expression
    radius: Expression


@dataclass(eq=False)
class Mandelbulb:
    iterations: Expression
    threshold: Expression
    power: Expression
    constant: Optional[Expression] = None


@dataclass(eq=False)
class QuaternionJulia:
    iterations: Expression
    threshold: Expression
    constant: Expression
    slice_plane: Expression
    variant: str = "regular"


@dataclass(eq=False)
class RayMarched:
    shape: object  # Mandelbulb | QuaternionJulia
    bounds: object  # BoundingBox | BoundingSphere
    material: Material


@dataclass(eq=False)
class Mesh:
    file: str
    materials: dict  # name -> Material
    scale: Optional[Expression] = None
    transform: Optional[LookAt] = None


@dataclass(eq=False)
class DirectionalLight:
    direction: Expression
    width: Expression
    color: Expression


@dataclass(eq=False)
class PointLight:
    position: Expression
    color: Expression


@dataclass(eq=False)
class World:
    objects: list
    sky: Optional[Expression] = None


@dataclass(eq=False)
class Image:
    width: int
    height: int
    file: Optional[str] = None
    filter: Optional[Expression] = None
    white: Optional[Expression] = None


@dataclass(eq=False)
class Project:
    image: Image
    camera: Camera
    renderer: RendererSettings
    world: World


# =============================================================================
# Lua table -> IR conversion
# =============================================================================


class IrBuilder:
    def __init__(self):
        self._expr_cache: dict[int, ComplexExpression] = {}
        self._material_cache: dict[int, MaterialNode] = {}
        self._spectrum_cache: dict[int, SpectrumIR] = {}

    # -- primitives ---------------------------------------------------------
    @staticmethod
    def _num(value, what="number") -> float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ProjectError(f"expected a {what}, got {type(value).__name__}")
        return float(value)

    @staticmethod
    def _get(table: LuaTable, key, what):
        value = table.get(key)
        if value is None:
            raise ProjectError(f"missing field '{key}' in {what}")
        return value

    def expression(self, value) -> Expression:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if not isinstance(value, LuaTable):
            raise ProjectError(f"expected an expression, got {type(value).__name__}")
        cached = self._expr_cache.get(id(value))
        if cached is not None:
            return cached
        kind = value.get("type")
        node = ComplexExpression(kind=kind)
        self._expr_cache[id(value)] = node  # insert first: cycles are invalid anyway
        f = node.fields
        if kind == "vector":
            for axis in ("x", "y", "z", "w"):
                f[axis] = self.expression(self._get(value, axis, "vector"))
        elif kind == "rgb":
            for channel in ("red", "green", "blue"):
                f[channel] = self.expression(self._get(value, channel, "rgb"))
        elif kind == "binary":
            f["operator"] = value.get("operator")
            if f["operator"] not in ("add", "sub", "mul", "div"):
                raise ProjectError(f"unknown binary operator {f['operator']!r}")
            f["lhs"] = self.expression(self._get(value, "lhs", "binary"))
            f["rhs"] = self.expression(self._get(value, "rhs", "binary"))
        elif kind == "mix":
            f["amount"] = self.expression(self._get(value, "amount", "mix"))
            f["lhs"] = self.expression(self._get(value, "lhs", "mix"))
            f["rhs"] = self.expression(self._get(value, "rhs", "mix"))
        elif kind == "clamp":
            f["value"] = self.expression(self._get(value, "value", "clamp"))
            f["min"] = self.expression(self._get(value, "min", "clamp"))
            f["max"] = self.expression(self._get(value, "max", "clamp"))
        elif kind == "fresnel":
            f["ior"] = self.expression(self._get(value, "ior", "fresnel"))
            env = value.get("env_ior")
            f["env_ior"] = self.expression(env if env is not None else 1.0)
        elif kind == "blackbody":
            f["temperature"] = self.expression(self._get(value, "temperature", "blackbody"))
        elif kind == "spectrum":
            f["spectrum"] = self.spectrum(value)
        elif kind in ("color_texture", "mono_texture"):
            f["path"] = self._get(value, "path", kind)
            f["linear"] = bool(value.get("linear"))
        else:
            raise ProjectError(f"unknown expression type {kind!r}")
        return node

    def opt_expression(self, value) -> Optional[Expression]:
        return None if value is None else self.expression(value)

    def spectrum(self, table: LuaTable) -> SpectrumIR:
        cached = self._spectrum_cache.get(id(table))
        if cached is not None:
            return cached
        name = table.get("name")
        if isinstance(name, str):
            spec = SpectrumIR(format="builtin", builtin=name)
        else:
            fmt = table.get("format")
            if fmt == "array":
                points = [
                    self._num(p, "spectrum point")
                    for p in self._get(table, "points", "array spectrum").array_items()
                ]
                spec = SpectrumIR(
                    format="array",
                    min=self._num(self._get(table, "min", "array spectrum")),
                    max=self._num(self._get(table, "max", "array spectrum")),
                    points=np.asarray(points, np.float32),
                )
            elif fmt == "curve":
                raw = table.get("points")
                pts = []
                if raw is not None:
                    for p in raw.array_items():
                        items = p.array_items()
                        pts.append((self._num(items[0]), self._num(items[1])))
                spec = SpectrumIR(format="curve", points=pts)
            else:
                raise ProjectError(f"unknown spectrum format {fmt!r}")
        self._spectrum_cache[id(table)] = spec
        return spec

    # -- materials ------------------------------------------------------------
    def material(self, table: LuaTable) -> Material:
        surface = table.get("surface")
        if surface is None:
            raise ProjectError("material is missing a surface")
        return Material(
            surface=self.material_node(surface),
            normal_map=self.opt_expression(table.get("normal_map")),
        )

    def material_node(self, table: LuaTable) -> MaterialNode:
        cached = self._material_cache.get(id(table))
        if cached is not None:
            return cached
        kind = table.get("type")
        node = MaterialNode(kind=kind)
        self._material_cache[id(table)] = node
        f = node.fields
        if kind in ("emissive", "diffuse", "mirror"):
            f["color"] = self.expression(self._get(table, "color", kind))
        elif kind == "refractive":
            f["color"] = self.expression(self._get(table, "color", kind))
            f["ior"] = self.expression(self._get(table, "ior", kind))
            f["dispersion"] = self.opt_expression(table.get("dispersion"))
            f["env_ior"] = self.opt_expression(table.get("env_ior"))
            f["env_dispersion"] = self.opt_expression(table.get("env_dispersion"))
        elif kind == "mix":
            f["lhs"] = self.material_node(self._get(table, "lhs", "mix material"))
            f["rhs"] = self.material_node(self._get(table, "rhs", "mix material"))
            f["amount"] = self.expression(self._get(table, "amount", "mix material"))
        elif kind == "binary":
            if table.get("operator") != "add":
                raise ProjectError("only 'add' is supported for material binary nodes")
            f["operator"] = "add"
            f["lhs"] = self.material_node(self._get(table, "lhs", "material add"))
            f["rhs"] = self.material_node(self._get(table, "rhs", "material add"))
        else:
            raise ProjectError(f"unknown material type {kind!r}")
        return node

    # -- scene ---------------------------------------------------------------
    def look_at(self, table: LuaTable) -> LookAt:
        if table.get("type") != "look_at":
            raise ProjectError(f"unknown transform type {table.get('type')!r}")
        return LookAt(
            from_=self.expression(self._get(table, "from", "look_at")),
            to=self.expression(self._get(table, "to", "look_at")),
            up=self.opt_expression(table.get("up")),
        )

    def camera(self, table: LuaTable) -> Camera:
        kind = table.get("type")
        if kind != "perspective":
            raise ProjectError(f"unknown camera type {kind!r}")
        return Camera(
            kind=kind,
            transform=self.look_at(self._get(table, "transform", "camera")),
            fov=self.expression(self._get(table, "fov", "camera")),
            focus_distance=self.opt_expression(table.get("focus_distance")),
            aperture=self.opt_expression(table.get("aperture")),
        )

    def renderer(self, table: LuaTable) -> RendererSettings:
        algorithm = table.get("type")
        if algorithm not in ("simple", "bidirectional", "photon_mapping"):
            raise ProjectError(f"unknown renderer type {algorithm!r}")

        def opt_int(key, default):
            v = table.get(key)
            return default if v is None else int(v)

        def opt_float(key, default):
            v = table.get(key)
            return default if v is None else float(v)

        settings = RendererSettings(
            algorithm=algorithm,
            pixel_samples=int(self._get(table, "pixel_samples", "renderer")),
            threads=None if table.get("threads") is None else int(table.get("threads")),
            bounces=opt_int("bounces", 8),
            light_samples=opt_int("light_samples", 4),
            spectrum_samples=opt_int("spectrum_samples", 10),
            spectrum_bins=opt_int("spectrum_resolution", 64),
            tile_size=opt_int("tile_size", 32),
        )
        if algorithm == "bidirectional":
            settings.light_bounces = opt_int("light_bounces", 8)
        if algorithm == "photon_mapping":
            settings.radius = opt_float("radius", 0.1)
            settings.photon_bounces = opt_int("photon_bounces", 8)
            settings.photons = opt_int("photons", 10000)
            settings.photon_passes = opt_int("photon_passes", 1)
        return settings

    def bounding_volume(self, table: LuaTable):
        kind = table.get("type")
        if kind == "box":
            return BoundingBox(
                min=self.expression(self._get(table, "min", "box bounds")),
                max=self.expression(self._get(table, "max", "box bounds")),
            )
        if kind == "sphere":
            return BoundingSphere(
                position=self.expression(self._get(table, "position", "sphere bounds")),
                radius=self.expression(self._get(table, "radius", "sphere bounds")),
            )
        raise ProjectError(f"unknown bounding volume {kind!r}")

    def estimator(self, table: LuaTable):
        kind = table.get("type")
        if kind == "mandelbulb":
            return Mandelbulb(
                iterations=self.expression(self._get(table, "iterations", kind)),
                threshold=self.expression(self._get(table, "threshold", kind)),
                power=self.expression(self._get(table, "power", kind)),
                constant=self.opt_expression(table.get("constant")),
            )
        if kind == "quaternion_julia":
            variant = self._get(table, "variant", kind)
            return QuaternionJulia(
                iterations=self.expression(self._get(table, "iterations", kind)),
                threshold=self.expression(self._get(table, "threshold", kind)),
                constant=self.expression(self._get(table, "constant", kind)),
                slice_plane=self.expression(self._get(table, "slice_plane", kind)),
                variant=variant.get("name") if isinstance(variant, LuaTable) else str(variant),
            )
        raise ProjectError(f"unknown ray-marched estimator {kind!r}")

    def world_object(self, table: LuaTable):
        kind = table.get("type")
        if kind == "sphere":
            return Sphere(
                position=self.expression(self._get(table, "position", kind)),
                radius=self.expression(self._get(table, "radius", kind)),
                texture_scale=self.opt_expression(table.get("texture_scale")),
                material=self.material(self._get(table, "material", kind)),
            )
        if kind == "plane":
            return Plane(
                origin=self.expression(self._get(table, "origin", kind)),
                normal=self.expression(self._get(table, "normal", kind)),
                texture_scale=self.opt_expression(table.get("texture_scale")),
                material=self.material(self._get(table, "material", kind)),
            )
        if kind == "ray_marched":
            return RayMarched(
                shape=self.estimator(self._get(table, "shape", kind)),
                bounds=self.bounding_volume(self._get(table, "bounds", kind)),
                material=self.material(self._get(table, "material", kind)),
            )
        if kind == "mesh":
            materials = {}
            mat_table = self._get(table, "materials", kind)
            for name, mat in mat_table.hash.items():
                materials[str(name)] = self.material(mat)
            transform = table.get("transform")
            return Mesh(
                file=self._get(table, "file", kind),
                materials=materials,
                scale=self.opt_expression(table.get("scale")),
                transform=None if transform is None else self.look_at(transform),
            )
        if kind == "directional_light":
            return DirectionalLight(
                direction=self.expression(self._get(table, "direction", kind)),
                width=self.expression(self._get(table, "width", kind)),
                color=self.expression(self._get(table, "color", kind)),
            )
        if kind == "point_light":
            return PointLight(
                position=self.expression(self._get(table, "position", kind)),
                color=self.expression(self._get(table, "color", kind)),
            )
        raise ProjectError(f"unknown world object {kind!r}")

    def world(self, table: LuaTable) -> World:
        objects_table = self._get(table, "objects", "world")
        return World(
            sky=self.opt_expression(table.get("sky")),
            objects=[self.world_object(o) for o in objects_table.array_items()],
        )

    def image(self, table: LuaTable) -> Image:
        return Image(
            width=int(self._get(table, "width", "image")),
            height=int(self._get(table, "height", "image")),
            file=table.get("file"),
            filter=self.opt_expression(table.get("filter")),
            white=self.opt_expression(table.get("white")),
        )

    def project(self, table: LuaTable) -> Project:
        return Project(
            image=self.image(self._get(table, "image", "project")),
            camera=self.camera(self._get(table, "camera", "project")),
            renderer=self.renderer(self._get(table, "renderer", "project")),
            world=self.world(self._get(table, "world", "project")),
        )


# =============================================================================
# Constant evaluation of expressions (reference: eval_context.rs/expressions.rs)
# =============================================================================


def eval_number(expr: Expression) -> float:
    v = _eval(expr)
    if isinstance(v, np.ndarray):
        raise ProjectError("expected a number, found a vector")
    return float(v)


def eval_vector4(expr: Expression) -> np.ndarray:
    v = _eval(expr)
    if not isinstance(v, np.ndarray):
        return np.full(4, float(v), np.float32)
    return v


def eval_vector3(expr: Expression) -> np.ndarray:
    return eval_vector4(expr)[:3]


def eval_vector2(expr: Expression) -> np.ndarray:
    return eval_vector4(expr)[:2]


def _eval(expr: Expression):
    if isinstance(expr, float):
        return expr
    kind = expr.kind
    f = expr.fields
    if kind == "vector":
        return np.array(
            [eval_number(f[axis]) for axis in ("x", "y", "z", "w")], np.float32
        )
    if kind == "binary":
        lhs = _eval(f["lhs"])
        rhs = _eval(f["rhs"])
        op = f["operator"]
        if op == "add":
            return lhs + rhs
        if op == "sub":
            return lhs - rhs
        if op == "mul":
            return lhs * rhs
        return lhs / rhs
    if kind == "mix":
        amount = min(max(eval_number(f["amount"]), 0.0), 1.0)
        lhs = _eval(f["lhs"])
        rhs = _eval(f["rhs"])
        return lhs * (1.0 - amount) + rhs * amount
    if kind == "clamp":
        return min(max(eval_number(f["value"]), eval_number(f["min"])), eval_number(f["max"]))
    raise ProjectError(f"cannot evaluate {kind} expressions as constants")
