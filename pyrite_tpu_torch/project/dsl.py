"""The pyrite scene-description DSL, implemented natively against our Lua VM.

This re-implements the behavior of the reference's bundled Lua library
(pyrite/src/project/lib.lua): prototype objects with
``:clone()``/``:with{}``, operator-overloaded expression building, and the
constructor namespaces (shape.*, material.*, camera.*, renderer.*, ...).
Scene files written for the reference run unmodified.
"""

from __future__ import annotations

import itertools

from ..lua.interpreter import Interpreter, LuaTable, lua_tostring


def install_dsl(interp: Interpreter):
    g = interp.globals
    id_counter = itertools.count()

    def assign_id(table):
        # Unconditionally assigns a fresh id, like the reference Tables::assign_id.
        table.set("_id", float(next(id_counter)))

    g.set("assign_id", assign_id)

    def make_object(obj, meta):
        obj.metatable = meta
        assign_id(obj)

    # --- basics metatable: clone / with -------------------------------------
    basics_mt = LuaTable()
    basics_mt.set("__index", basics_mt)

    def _clone(self):
        if isinstance(self, LuaTable):
            cloned = LuaTable()
            for k, v in list(self.hash.items()):
                cloned.hash[k] = v
            make_object(cloned, self.metatable)
            return cloned
        return self

    def _with(self, new_properties):
        cloned = _clone(self)
        if not isinstance(new_properties, LuaTable):
            # function form: with(function(cloned) return {...} end)
            result = interp.call(new_properties, [cloned])
            new_properties = result[0] if result else LuaTable()
        for k, v in list(new_properties.hash.items()):
            cloned.hash[k] = v
        return cloned

    basics_mt.set("clone", _clone)
    basics_mt.set("with", _with)

    def make_basic(obj):
        make_object(obj, basics_mt)
        return obj

    # --- expression metatable: arithmetic + mix ------------------------------
    expression_mt = LuaTable()
    expression_mt.set("__index", expression_mt)
    exp_meta_meta = LuaTable()
    exp_meta_meta.set("__index", basics_mt)
    expression_mt.metatable = exp_meta_meta

    def make_expression(obj):
        make_object(obj, expression_mt)
        return obj

    def binary_operator(operator, lhs, rhs):
        node = LuaTable()
        node.set("type", "binary")
        node.set("operator", operator)
        node.set("lhs", lhs)
        node.set("rhs", rhs)
        return make_expression(node)

    expression_mt.set("__add", lambda a, b: binary_operator("add", a, b))
    expression_mt.set("__sub", lambda a, b: binary_operator("sub", a, b))
    expression_mt.set("__mul", lambda a, b: binary_operator("mul", a, b))
    expression_mt.set("__div", lambda a, b: binary_operator("div", a, b))

    def _mix(self, other=None, amount=None):
        if isinstance(self, LuaTable) and self.get("type") is None:
            props = self
            props.set("type", "mix")
        else:
            props = LuaTable()
            props.set("type", "mix")
            props.set("lhs", self)
            props.set("rhs", other)
            props.set("amount", amount)
        return make_expression(props)

    expression_mt.set("mix", _mix)
    g.set("mix", _mix)

    # --- expression constructors ---------------------------------------------
    def _fresnel(ior, env_ior=None):
        node = LuaTable()
        node.set("type", "fresnel")
        node.set("ior", ior)
        node.set("env_ior", env_ior if env_ior is not None else 1.0)
        return make_expression(node)

    def _vector(x=None, y=None, z=None, w=None):
        node = LuaTable()
        node.set("type", "vector")
        if isinstance(x, LuaTable) and x.get("type") is None:
            node.set("x", x.get("x") or 0.0)
            node.set("y", x.get("y") or 0.0)
            node.set("z", x.get("z") or 0.0)
            node.set("w", x.get("w") or 0.0)
        else:
            node.set("x", x or 0.0)
            node.set("y", y or 0.0)
            node.set("z", z or 0.0)
            node.set("w", w or 0.0)
        return make_expression(node)

    def _blackbody(temperature):
        node = LuaTable()
        node.set("type", "blackbody")
        node.set("temperature", temperature)
        return make_expression(node)

    def _spectrum(props):
        props.set("type", "spectrum")
        return make_expression(props)

    def _rgb(red=None, green=None, blue=None):
        node = LuaTable()
        node.set("type", "rgb")
        node.set("red", red or 0.0)
        node.set("green", green or 0.0)
        node.set("blue", blue or 0.0)
        return make_expression(node)

    def _texture(path, *modifiers):
        node = LuaTable()
        node.set("type", "color_texture")
        node.set("path", path)
        node.set("linear", False)
        node.set("mono", False)
        for modifier in modifiers:
            if isinstance(modifier, str):
                node.set(modifier, True)
        if node.get("mono"):
            node.set("type", "mono_texture")
        return make_expression(node)

    g.set("fresnel", _fresnel)
    g.set("vector", _vector)
    g.set("blackbody", _blackbody)
    g.set("spectrum", _spectrum)
    g.set("rgb", _rgb)
    g.set("texture", _texture)

    # --- tagged-table constructor namespaces ---------------------------------
    def tagger(type_name, maker):
        def construct(props):
            props.set("type", type_name)
            return maker(props)

        return construct

    def namespace(entries, maker):
        table = LuaTable()
        for name, type_name in entries.items():
            table.set(name, tagger(type_name, maker))
        return table

    g.set(
        "shape",
        namespace(
            {
                "sphere": "sphere",
                "plane": "plane",
                "mesh": "mesh",
                "ray_marched": "ray_marched",
            },
            make_basic,
        ),
    )
    g.set(
        "ray_marched",
        namespace(
            {"quaternion_julia": "quaternion_julia", "mandelbulb": "mandelbulb"},
            make_basic,
        ),
    )

    quaternion_julia = LuaTable()
    cubic = LuaTable()
    cubic.set("type", "quaternion_julia")
    cubic.set("name", "cubic")
    make_basic(cubic)
    quaternion_julia.set("cubic", cubic)
    g.set("quaternion_julia", quaternion_julia)

    g.set("bounds", namespace({"box": "box"}, make_basic))
    g.set(
        "material",
        namespace(
            {
                "diffuse": "diffuse",
                "emissive": "emissive",
                "mirror": "mirror",
                "refractive": "refractive",
            },
            make_expression,
        ),
    )

    light_source = LuaTable()
    for name in ("d65", "a"):
        node = LuaTable()
        node.set("type", "spectrum")
        node.set("name", name)
        make_expression(node)
        light_source.set(name, node)
    g.set("light_source", light_source)

    g.set("transform", namespace({"look_at": "look_at"}, make_basic))
    g.set("camera", namespace({"perspective": "perspective"}, make_basic))
    g.set(
        "renderer",
        namespace(
            {
                "simple": "simple",
                "bidirectional": "bidirectional",
                "photon_mapping": "photon_mapping",
            },
            make_basic,
        ),
    )
    g.set("light", namespace({"point": "point_light"}, make_basic))

    # --- dump (debug helper available to scene authors) ----------------------
    def _dump(o, t=None):
        tabs = int(t) if t is not None else 1
        if isinstance(o, LuaTable):
            parts = ["{\n"]
            for k, v in o.hash.items():
                parts.append("  " * tabs)
                key = k if isinstance(k, (int, float)) else f'"{k}"'
                parts.append(f"[{key}] = {_dump(v, tabs + 1)},\n")
            parts.append("  " * (tabs - 1))
            parts.append("}")
            return "".join(parts)
        return lua_tostring(o)

    g.set("dump", _dump)
