"""A small Lua interpreter used for pyrite-compatible scene descriptions.

The reference front end embeds real Lua (mlua) and loads scenes written in a
Lua DSL (reference: pyrite/src/project/mod.rs:29-93). This
package provides an independent Lua implementation covering the language
subset that scene files use: tables + metatables, closures, operator
metamethods, varargs, multiple returns, control flow, and a small stdlib.
"""

from .interpreter import Interpreter, LuaError, LuaTable, LuaFunction  # noqa: F401
