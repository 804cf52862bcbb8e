"""Scene-project front end: Lua DSL, typed IR, and resource loaders."""

from .load import load_project  # noqa: F401
