"""Minimal Lua standard library for scene scripts."""

from __future__ import annotations

import math

from .interpreter import Coroutine, LuaTable, LuaError, lua_tostring, is_truthy


def install(interp):
    g = interp.globals

    def _print(*args):
        print("\t".join(lua_tostring(a) for a in args))

    def _type(value=None):
        if value is None:
            return "nil"
        if isinstance(value, bool):
            return "boolean"
        if isinstance(value, float):
            return "number"
        if isinstance(value, str):
            return "string"
        if isinstance(value, LuaTable):
            return "table"
        if isinstance(value, Coroutine):
            return "thread"
        return "function"

    def _tostring(value=None):
        return lua_tostring(value)

    def _tonumber(value=None, base=None):
        if base is not None:
            try:
                return float(int(str(value), int(base)))
            except (ValueError, TypeError):
                return None
        if isinstance(value, float):
            return value
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                return None
        return None

    def _pairs(table):
        if not isinstance(table, LuaTable):
            raise LuaError("bad argument to 'pairs' (table expected)")
        items = list(table.hash.items())

        state = {"i": 0}

        def iterator(_state=None, _control=None):
            while state["i"] < len(items):
                k, v = items[state["i"]]
                state["i"] += 1
                if isinstance(k, int):
                    k = float(k)
                if table.get(k) is not None:
                    return (k, v)
            return None

        return (iterator, table, None)

    def _ipairs(table):
        def iterator(tbl, i):
            i = int(i) + 1
            v = tbl.get(float(i))
            if v is None:
                return None
            return (float(i), v)

        return (iterator, table, 0.0)

    def _next(table, key=None):
        items = list(table.hash.items())
        if key is None:
            idx = 0
        else:
            from .interpreter import _normkey

            nk = _normkey(key)
            idx = None
            for i, (k, _) in enumerate(items):
                if k == nk:
                    idx = i + 1
                    break
            if idx is None:
                raise LuaError("invalid key to 'next'")
        if idx < len(items):
            k, v = items[idx]
            if isinstance(k, int):
                k = float(k)
            return (k, v)
        return None

    def _setmetatable(table, meta=None):
        if not isinstance(table, LuaTable):
            raise LuaError("bad argument to 'setmetatable'")
        table.metatable = meta
        return table

    def _getmetatable(table=None):
        if isinstance(table, LuaTable):
            return table.metatable
        return None

    def _rawget(table, key):
        return table.get(key)

    def _rawset(table, key, value=None):
        table.set(key, value)
        return table

    def _rawequal(a=None, b=None):
        return a is b or a == b if not isinstance(a, LuaTable) else a is b

    def _require(name):
        return interp.require(name)

    def _error(message=None, _level=None):
        raise LuaError(lua_tostring(message))

    def _assert(value=None, message=None, *rest):
        if not is_truthy(value):
            raise LuaError(lua_tostring(message) if message is not None else "assertion failed!")
        return (value, message, *rest)

    def _load(chunk, _chunkname=None, _mode=None, _env=None):
        """load(chunk): compile a string (or reader function) into a
        callable; returns (nil, message) on syntax errors like PUC-Lua."""
        from .parser import parse
        from .lexer import LuaSyntaxError
        from .interpreter import Env, _Return

        if not isinstance(chunk, str):
            parts = []
            while True:
                r = interp.call(chunk, [])
                piece = r[0] if r else None
                if piece is None or piece == "":
                    break
                parts.append(piece)
            chunk = "".join(parts)
        try:
            body = parse(chunk, str(_chunkname) if _chunkname else "=(load)")
        except LuaSyntaxError as error:
            return (None, str(error))

        def runner(*args):
            env = Env()
            env.vars["..."] = list(args)
            try:
                interp.exec_block(body, env)
            except _Return as ret:
                return tuple(ret.values)
            return None

        return runner

    def _dofile(path):
        with open(path) as fh:
            fn = _load(fh.read(), path)
        if isinstance(fn, tuple):
            raise LuaError(lua_tostring(fn[1]))
        return tuple(interp.call(fn, []))

    def _pcall(func, *args):
        try:
            result = interp.call(func, list(args))
            return tuple([True] + result)
        except LuaError as e:
            return (False, str(e))

    def _xpcall(func, handler, *args):
        try:
            result = interp.call(func, list(args))
            return tuple([True] + result)
        except LuaError as e:
            try:
                handled = interp.call(handler, [str(e)])
            except LuaError:
                return (False, "error in error handling")
            return tuple([False] + handled)

    def _select(what, *args):
        if what == "#":
            return float(len(args))
        i = int(what)
        return tuple(args[i - 1:])

    def _unpack(table, i=None, j=None):
        i = int(i) if i is not None else 1
        j = int(j) if j is not None else table.lua_len()
        return tuple(table.get(float(k)) for k in range(i, j + 1))

    for name, fn in {
        "print": _print,
        "type": _type,
        "tostring": _tostring,
        "tonumber": _tonumber,
        "pairs": _pairs,
        "ipairs": _ipairs,
        "next": _next,
        "setmetatable": _setmetatable,
        "getmetatable": _getmetatable,
        "rawget": _rawget,
        "rawset": _rawset,
        "rawequal": _rawequal,
        "require": _require,
        "error": _error,
        "assert": _assert,
        "pcall": _pcall,
        "xpcall": _xpcall,
        "select": _select,
        "unpack": _unpack,
        "load": _load,
        "loadstring": _load,  # Lua 5.1 alias
        "dofile": _dofile,
    }.items():
        g.set(name, fn)

    # math ---------------------------------------------------------------
    math_table = LuaTable()
    for name, fn in {
        "floor": lambda x: float(math.floor(x)),
        "ceil": lambda x: float(math.ceil(x)),
        "abs": lambda x: abs(float(x)),
        "sqrt": lambda x: math.sqrt(x),
        "sin": math.sin,
        "cos": math.cos,
        "tan": math.tan,
        "asin": math.asin,
        "acos": math.acos,
        "atan": math.atan,
        "exp": math.exp,
        "log": lambda x, base=None: math.log(x, base) if base else math.log(x),
        "pow": lambda x, y: float(x) ** float(y),
        "fmod": math.fmod,
        "rad": math.radians,
        "deg": math.degrees,
        "max": lambda *xs: max(float(x) for x in xs),
        "min": lambda *xs: min(float(x) for x in xs),
        "modf": lambda x: (float(int(x)), x - int(x)),
    }.items():
        math_table.set(name, fn)
    # math.random mirrors the PUC-Lua surface: () -> [0,1), (m) -> [1,m],
    # (m, n) -> [m,n]; the stream is per-interpreter (scene loads stay
    # reproducible across runs via the fixed default seed)
    import random as _random

    rng = _random.Random(0)

    def _math_random(m=None, n=None):
        if m is None:
            return rng.random()
        m = int(m)
        if n is None:
            if m < 1:
                raise LuaError("bad argument #1 to 'random' (interval is empty)")
            return float(rng.randint(1, m))
        n = int(n)
        if m > n:
            raise LuaError("bad argument #2 to 'random' (interval is empty)")
        return float(rng.randint(m, n))

    math_table.set("random", _math_random)
    math_table.set("randomseed", lambda x=None: rng.seed(int(x) if x is not None else 0))
    math_table.set("pi", math.pi)
    math_table.set("huge", math.inf)
    g.set("math", math_table)

    # string ----------------------------------------------------------------
    def _format(fmt, *args):
        # Translate the common Lua format specs onto Python %-formatting.
        out = []
        arg_iter = iter(args)
        i = 0
        while i < len(fmt):
            c = fmt[i]
            if c == "%" and i + 1 < len(fmt):
                j = i + 1
                while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                    j += 1
                spec = fmt[i : j + 1]
                kind = fmt[j]
                if kind == "%":
                    out.append("%")
                elif kind in "di":
                    out.append(("%" + spec[1:-1] + "d") % int(next(arg_iter)))
                elif kind in "fgGeE":
                    out.append(spec % float(next(arg_iter)))
                elif kind == "s":
                    out.append(spec % lua_tostring(next(arg_iter)))
                elif kind in "xX":
                    out.append(spec % int(next(arg_iter)))
                elif kind == "q":
                    out.append('"%s"' % lua_tostring(next(arg_iter)).replace('"', '\\"'))
                else:
                    raise LuaError(f"unsupported format spec %{kind}")
                i = j + 1
            else:
                out.append(c)
                i += 1
        return "".join(out)

    # full Lua 5.1 pattern engine (find/match/gmatch/gsub) — the reference
    # embeds real Lua (project/mod.rs:35-58 via mlua), so arbitrary user
    # scenes may use patterns even though the shipped scenes don't
    from . import patterns as _pat

    def _norm_init(s, init):
        n = len(s)
        i = int(init) if init is not None else 1
        if i < 0:
            i = max(n + i + 1, 1)
        elif i == 0:
            i = 1
        return i - 1  # 0-based; may equal n (empty-at-end matches allowed)

    def _str_find(s, pattern, init=None, plain=None):
        start = _norm_init(s, init)
        if start > len(s):
            return None
        if is_truthy(plain):
            idx = s.find(pattern, start)
            if idx < 0:
                return None
            return (float(idx + 1), float(idx + len(pattern)))
        found = _pat.pattern_find(s, pattern, start)
        if found is None:
            return None
        b, e, caps = found
        return tuple([float(b + 1), float(e)] + caps)

    def _str_match(s, pattern, init=None):
        start = _norm_init(s, init)
        if start > len(s):
            return None
        caps = _pat.pattern_match(s, pattern, start)
        if caps is None:
            return None
        return tuple(caps) if len(caps) > 1 else caps[0]

    def _str_gmatch(s, pattern):
        it = _pat.pattern_gmatch(s, pattern)

        def iterator(_state=None, _control=None):
            for caps in it:
                return tuple(caps) if len(caps) > 1 else caps[0]
            return None

        return iterator

    def _gsub_call(repl, caps):
        if isinstance(repl, LuaTable):
            return repl.get(caps[0])
        result = interp.call(repl, list(caps))
        return result[0] if result else None

    def _str_gsub(s, pattern, repl, n=None):
        new, count = _pat.pattern_gsub(
            s, pattern, repl,
            max_n=int(n) if n is not None else None, call=_gsub_call,
        )
        return (new, float(count))

    string_table = LuaTable()
    for name, fn in {
        "format": _format,
        "rep": lambda s, count, sep=None: ((sep or "").join([s] * int(count)) if sep else s * int(count)),
        "sub": lambda s, i, j=None: _str_sub(s, i, j),
        "upper": lambda s: s.upper(),
        "lower": lambda s: s.lower(),
        "len": lambda s: float(len(s)),
        "byte": lambda s, i=None: float(ord(s[int(i or 1) - 1])),
        "char": lambda *cs: "".join(chr(int(c)) for c in cs),
        "reverse": lambda s: s[::-1],
        "gsub": _str_gsub,
        "find": _str_find,
        "match": _str_match,
        "gmatch": _str_gmatch,
    }.items():
        string_table.set(name, fn)
    g.set("string", string_table)

    # table -------------------------------------------------------------
    def _insert(table, a, b=None):
        if b is None:
            table.set(float(table.lua_len() + 1), a)
        else:
            pos = int(a)
            for k in range(table.lua_len(), pos - 1, -1):
                table.set(float(k + 1), table.get(float(k)))
            table.set(float(pos), b)

    def _remove(table, pos=None):
        n = table.lua_len()
        if n == 0:
            return None
        pos = int(pos) if pos is not None else n
        value = table.get(float(pos))
        for k in range(pos, n):
            table.set(float(k), table.get(float(k + 1)))
        table.set(float(n), None)
        return value

    def _concat(table, sep=None, i=None, j=None):
        sep = sep or ""
        i = int(i) if i is not None else 1
        j = int(j) if j is not None else table.lua_len()
        return sep.join(lua_tostring(table.get(float(k))) for k in range(i, j + 1))

    def _sort(table, comp=None):
        import functools

        items = table.array_items()
        if comp is not None:
            def cmp(a, b):
                res = interp.call(comp, [a, b])
                return -1 if (res and is_truthy(res[0])) else 1
            items.sort(key=functools.cmp_to_key(cmp))
        else:
            items.sort()
        for idx, v in enumerate(items):
            table.set(float(idx + 1), v)

    table_table = LuaTable()
    for name, fn in {
        "insert": _insert,
        "remove": _remove,
        "concat": _concat,
        "sort": _sort,
        "unpack": _unpack,
    }.items():
        table_table.set(name, fn)
    g.set("table", table_table)

    # coroutine ----------------------------------------------------------
    # mlua embeds the full Lua VM (reference project/mod.rs:35-58), so
    # arbitrary user scenes can drive generators/schedulers; Coroutine
    # (interpreter.py) runs each on a handed-off thread.
    def _co_create(func):
        return Coroutine(interp, func)

    def _co_resume(co, *args):
        if not isinstance(co, Coroutine):
            raise LuaError("bad argument #1 to 'resume' (coroutine expected)")
        return co.resume(list(args))

    def _co_yield(*args):
        co = interp.current_coroutine()
        if co is None:
            raise LuaError("attempt to yield from outside a coroutine")
        return co.yield_(list(args))

    def _co_status(co):
        if not isinstance(co, Coroutine):
            raise LuaError("bad argument #1 to 'status' (coroutine expected)")
        return co.status

    def _co_wrap(func):
        co = Coroutine(interp, func)

        def wrapped(*args):
            result = co.resume(list(args))
            if not result[0]:
                raise LuaError(lua_tostring(result[1]))
            return result[1:]

        return wrapped

    def _co_running():
        co = interp.current_coroutine()
        if co is None:
            return (None, True)
        return (co, False)

    def _co_isyieldable():
        return interp.current_coroutine() is not None

    co_table = LuaTable()
    for name, fn in {
        "create": _co_create,
        "resume": _co_resume,
        "yield": _co_yield,
        "status": _co_status,
        "wrap": _co_wrap,
        "running": _co_running,
        "isyieldable": _co_isyieldable,
    }.items():
        co_table.set(name, fn)
    g.set("coroutine", co_table)

    # os -----------------------------------------------------------------
    import os as _os
    import time as _time

    def _os_date(fmt=None, t=None):
        fmt = fmt or "%c"
        when = _time.localtime(t) if t is not None else _time.localtime()
        if fmt.startswith("!"):
            when = _time.gmtime(t) if t is not None else _time.gmtime()
            fmt = fmt[1:]
        if fmt.startswith("*t"):
            out = LuaTable()
            out.set("year", float(when.tm_year))
            out.set("month", float(when.tm_mon))
            out.set("day", float(when.tm_mday))
            out.set("hour", float(when.tm_hour))
            out.set("min", float(when.tm_min))
            out.set("sec", float(when.tm_sec))
            out.set("wday", float(when.tm_wday + 2 if when.tm_wday < 6 else 1))
            out.set("yday", float(when.tm_yday))
            out.set("isdst", bool(when.tm_isdst))
            return out
        return _time.strftime(fmt, when)

    def _os_time(t=None):
        if t is None:
            return float(_time.time())
        if not isinstance(t, LuaTable):
            raise LuaError("bad argument #1 to 'time' (table expected)")

        def field(name, default=None):
            val = t.get(name)
            if val is None:
                if default is None:
                    raise LuaError(
                        "field '%s' missing in date table" % name
                    )
                return default
            return int(val)

        import time as _t
        return float(_t.mktime((
            field("year"), field("month"), field("day"),
            field("hour", 12), field("min", 0), field("sec", 0),
            -1, -1, -1,
        )))

    os_table = LuaTable()
    for name, fn in {
        "time": _os_time,
        "clock": lambda: float(_time.process_time()),
        "date": _os_date,
        "difftime": lambda t2, t1=0.0: float(t2) - float(t1),
        "getenv": lambda name: _os.environ.get(name),
    }.items():
        os_table.set(name, fn)
    g.set("os", os_table)

    # io -----------------------------------------------------------------
    # file handles are tables with bound methods (scene scripts call
    # f:read(...), f:write(...), f:lines(), f:close())
    import sys as _sys

    def _read_one(fh, what):
        if isinstance(what, float):
            data = fh.read(int(what))
            return data if data else None
        what = (what or "l").lstrip("*")
        if what.startswith("a"):
            return fh.read()
        if what.startswith("n"):
            word = fh.readline().strip()
            try:
                return float(word)
            except ValueError:
                return None
        line = fh.readline()
        if not line:
            return None
        if what.startswith("l"):
            return line.rstrip("\n")
        return line  # 'L': keep the newline

    def _wrap_file(fh):
        handle = LuaTable()

        def f_read(_self, *whats):
            if not whats:
                return _read_one(fh, "l")
            return tuple(_read_one(fh, w) for w in whats)

        def f_write(_self, *parts):
            for p in parts:
                fh.write(p if isinstance(p, str) else lua_tostring(p))
            return handle

        def f_lines(_self=None):
            def iterator(_state=None, _control=None):
                line = fh.readline()
                return line.rstrip("\n") if line else None

            return iterator

        def f_close(_self=None):
            fh.close()
            return True

        def f_seek(_self, whence=None, offset=None):
            whence = whence or "cur"
            offset = int(offset) if offset is not None else 0
            fh.seek(offset, {"set": 0, "cur": 1, "end": 2}[whence])
            return float(fh.tell())

        handle.set("read", f_read)
        handle.set("write", f_write)
        handle.set("lines", f_lines)
        handle.set("close", f_close)
        handle.set("seek", f_seek)
        return handle

    def _io_open(path, mode=None):
        mode = (mode or "r").replace("b", "") + ("b" if "b" in (mode or "") else "")
        try:
            fh = open(path, mode or "r")
        except OSError as error:
            return (None, f"{path}: {error.strerror}")
        return _wrap_file(fh)

    def _io_lines(path=None):
        if path is None:
            return _wrap_file(_sys.stdin).get("lines")(None)
        fh = open(path, "r")
        table = _wrap_file(fh)

        def iterator(_state=None, _control=None):
            line = fh.readline()
            if not line:
                fh.close()
                return None
            return line.rstrip("\n")

        return iterator

    def _io_write(*parts):
        _sys.stdout.write(
            "".join(p if isinstance(p, str) else lua_tostring(p) for p in parts)
        )

    io_table = LuaTable()
    io_table.set("write", _io_write)
    io_table.set("read", lambda *whats: _read_one(_sys.stdin, whats[0] if whats else "l"))
    io_table.set("open", _io_open)
    io_table.set("lines", _io_lines)
    g.set("io", io_table)

    # package ------------------------------------------------------------
    package = LuaTable()
    package.set("path", "./?.lua")
    g.set("package", package)
    g.set("_G", g)


def _str_sub(s, i, j=None):
    i = int(i)
    j = int(j) if j is not None else -1
    n = len(s)
    if i < 0:
        i = max(n + i + 1, 1)
    elif i == 0:
        i = 1
    if j < 0:
        j = n + j + 1
    elif j > n:
        j = n
    if i > j:
        return ""
    return s[i - 1 : j]


