"""Tree-walking Lua interpreter.

Covers the language subset exercised by pyrite scene files (reference DSL:
pyrite/src/project/lib.lua): tables with metatables, closures,
operator metamethods, varargs, multiple returns, and the usual control flow.
"""

from __future__ import annotations

from .parser import parse


class LuaError(Exception):
    pass


class _Goto(Exception):
    """goto control transfer: propagates outward until a block containing
    the target ::label:: catches it (Lua 5.2+ visibility: the label must be
    in the current or an enclosing block)."""

    def __init__(self, label):
        self.label = label


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values


def _normkey(key):
    """Lua numbers are doubles; integral floats index like ints."""
    if isinstance(key, float) and key.is_integer():
        return int(key)
    if isinstance(key, bool):  # bool is an int subclass in Python; keep distinct
        return ("__bool__", key)
    return key


class LuaTable:
    __slots__ = ("hash", "metatable")

    def __init__(self, items=None):
        self.hash = {}
        self.metatable = None
        if items:
            for k, v in items.items():
                self.set(k, v)

    # raw access -------------------------------------------------------------
    def get(self, key):
        return self.hash.get(_normkey(key))

    def set(self, key, value):
        key = _normkey(key)
        if key is None:
            raise LuaError("table index is nil")
        if value is None:
            self.hash.pop(key, None)
        else:
            self.hash[key] = value

    def lua_len(self):
        n = 0
        while (n + 1) in self.hash:
            n += 1
        return n

    def array_items(self):
        out = []
        i = 1
        while i in self.hash:
            out.append(self.hash[i])
            i += 1
        return out

    def __repr__(self):
        return f"LuaTable({len(self.hash)} items)"


class LuaFunction:
    __slots__ = ("params", "is_vararg", "body", "env", "interp", "name")

    def __init__(self, params, is_vararg, body, env, interp, name="?"):
        self.params = params
        self.is_vararg = is_vararg
        self.body = body
        self.env = env
        self.interp = interp
        self.name = name

    def __call__(self, *args):
        """Allow host (Python) code to call Lua functions directly."""
        return self.interp.call(self, list(args))


class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def lookup(self, name):
        env = self
        while env is not None:
            if name in env.vars:
                return env
            env = env.parent
        return None


def lua_tostring(value):
    if value is None:
        return "nil"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, float):
        if value.is_integer() and abs(value) < 1e16:
            return str(int(value))
        return repr(value)
    if isinstance(value, str):
        return value
    if isinstance(value, LuaTable):
        if value.metatable is not None:
            ts = value.metatable.get("__tostring")
            if ts is not None:
                # host may register a python callable or LuaFunction
                result = ts(value)
                if isinstance(result, (list, tuple)):
                    result = result[0] if result else None
                return result
        return f"table: 0x{id(value):012x}"
    if callable(value):
        return f"function: 0x{id(value):012x}"
    return str(value)


def is_truthy(value):
    return value is not None and value is not False


class Coroutine:
    """Lua coroutine over a Python thread with strict two-way handoff: the
    resumer blocks until the coroutine yields/returns, and the coroutine
    blocks until resumed — execution is never concurrent, so the (shared)
    interpreter state needs no locking. mlua gives the reference the real
    Lua coroutine library (project/mod.rs:35-58); a tree-walking interpreter
    cannot suspend arbitrary native frames without its own stack, hence
    threads."""

    def __init__(self, interp, func):
        import queue

        self.interp = interp
        self.func = func
        self.status = "suspended"
        self._to_co = queue.Queue()
        self._from_co = queue.Queue()
        self._thread = None

    def _run(self, args):
        self.interp._co_local.current = self
        try:
            result = self.interp.call(self.func, list(args))
            self.status = "dead"
            self._from_co.put(("return", result))
        except LuaError as error:
            self.status = "dead"
            self._from_co.put(("error", str(error)))
        except BaseException as error:  # never leave the resumer blocked
            self.status = "dead"
            self._from_co.put(("error", f"{type(error).__name__}: {error}"))

    def resume(self, args):
        import threading

        if self.status == "dead":
            return (False, "cannot resume dead coroutine")
        if self.status != "suspended":
            return (False, "cannot resume non-suspended coroutine")
        prev = getattr(self.interp._co_local, "current", None)
        if prev is not None:
            prev.status = "normal"
        self.status = "running"
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, args=(args,), daemon=True
            )
            self._thread.start()
        else:
            self._to_co.put(args)
        kind, vals = self._from_co.get()
        if prev is not None:
            prev.status = "running"
        self.interp._co_local.current = prev
        if kind == "error":
            return (False, vals)
        return tuple([True] + list(vals))

    def yield_(self, args):
        self.status = "suspended"
        self._from_co.put(("yield", list(args)))
        sent = self._to_co.get()
        self.status = "running"
        self.interp._co_local.current = self
        return tuple(sent)


class Interpreter:
    def __init__(self, loader=None):
        """``loader(name)`` should return Lua source for require(), or None."""
        import threading

        self.globals = LuaTable()
        self.loader = loader
        self._loaded = {}
        self._co_local = threading.local()  # coroutine running on this thread
        from . import stdlib

        stdlib.install(self)

    def current_coroutine(self):
        return getattr(self._co_local, "current", None)

    # --- public API ---------------------------------------------------------
    def run(self, src: str, chunk_name: str = "?", varargs=()):
        body = parse(src, chunk_name)
        env = Env()
        env.vars["..."] = list(varargs)
        try:
            self.exec_block(body, env)
        except _Return as ret:
            return ret.values
        return []

    def require(self, name):
        if name in self._loaded:
            return self._loaded[name]
        if self.loader is None:
            raise LuaError(f"module '{name}' not found (no loader)")
        src = self.loader(name)
        if src is None:
            raise LuaError(f"module '{name}' not found")
        values = self.run(src, chunk_name=name)
        result = values[0] if values else True
        self._loaded[name] = result
        return result

    def call(self, func, args):
        """Call a Lua or native function with a list of args; returns a list."""
        if isinstance(func, LuaFunction):
            env = Env(func.env)
            for i, p in enumerate(func.params):
                env.vars[p] = args[i] if i < len(args) else None
            if func.is_vararg:
                env.vars["..."] = list(args[len(func.params):])
            try:
                self.exec_block(func.body, env)
            except _Return as ret:
                return ret.values
            except _Goto as g:
                # PUC-Lua rejects a goto to an invisible label at compile
                # time; here an unresolved goto must not escape into a
                # caller's block (or past pcall as a raw Python exception).
                raise LuaError(
                    "no visible label '%s' for goto" % (g.args[0],)
                )
            return []
        if isinstance(func, LuaTable):
            meta = func.metatable
            call = meta.get("__call") if meta is not None else None
            if call is None:
                raise LuaError("attempt to call a table value")
            return self.call(call, [func] + args)
        if callable(func):
            result = func(*args)
            if result is None:
                return []
            if isinstance(result, tuple):
                return list(result)
            return [result]
        raise LuaError(f"attempt to call a {type(func).__name__} value")

    # --- statements -----------------------------------------------------------
    def exec_block(self, stmts, env):
        i = 0
        n = len(stmts)
        while i < n:
            try:
                self.exec_stmt(stmts[i], env)
            except _Goto as g:
                for j, s in enumerate(stmts):
                    if s[0] == "label" and s[1] == g.label:
                        i = j
                        break
                else:
                    raise  # label not in this block: unwind to an enclosing one
            i += 1

    def exec_stmt(self, stmt, env):
        op = stmt[0]
        if op == "callstat":
            self.eval_multi(stmt[1], env)
        elif op == "local":
            _, names, exprs = stmt
            values = self.eval_list(exprs, env, len(names))
            for name, val in zip(names, values):
                env.vars[name] = val
        elif op == "assign":
            _, targets, exprs = stmt
            values = self.eval_list(exprs, env, len(targets))
            for target, val in zip(targets, values):
                self.assign(target, val, env)
        elif op == "if":
            _, clauses, else_body = stmt
            for cond, body in clauses:
                if is_truthy(self.eval(cond, env)):
                    self.exec_block(body, Env(env))
                    return
            self.exec_block(else_body, Env(env))
        elif op == "while":
            _, cond, body = stmt
            while is_truthy(self.eval(cond, env)):
                try:
                    self.exec_block(body, Env(env))
                except _Break:
                    break
        elif op == "repeat":
            _, body, cond = stmt
            while True:
                scope = Env(env)
                try:
                    self.exec_block(body, scope)
                except _Break:
                    break
                if is_truthy(self.eval(cond, scope)):
                    break
        elif op == "fornum":
            _, var, start, stop, step, body = stmt
            i = self.tonumber(self.eval(start, env), "for start")
            stop_v = self.tonumber(self.eval(stop, env), "for stop")
            step_v = self.tonumber(self.eval(step, env), "for step") if step else 1.0
            if step_v == 0:
                raise LuaError("'for' step is zero")
            while (step_v > 0 and i <= stop_v) or (step_v < 0 and i >= stop_v):
                scope = Env(env)
                scope.vars[var] = float(i)
                try:
                    self.exec_block(body, scope)
                except _Break:
                    break
                i += step_v
        elif op == "forin":
            _, names, exprs, body = stmt
            values = self.eval_list(exprs, env, 3)
            iter_fn, state, control = values[0], values[1], values[2]
            while True:
                results = self.call(iter_fn, [state, control])
                control = results[0] if results else None
                if control is None:
                    break
                scope = Env(env)
                for i, name in enumerate(names):
                    scope.vars[name] = results[i] if i < len(results) else None
                try:
                    self.exec_block(body, scope)
                except _Break:
                    break
        elif op == "do":
            self.exec_block(stmt[1], Env(env))
        elif op == "localfunc":
            _, name, func_ast = stmt
            env.vars[name] = None
            env.vars[name] = self.eval(func_ast, env)
        elif op == "return":
            values = self.eval_list(stmt[1], env, None)
            raise _Return(values)
        elif op == "break":
            raise _Break()
        elif op == "goto":
            raise _Goto(stmt[1])
        elif op == "label":
            pass  # jump target only; exec_block scans for it
        else:
            raise LuaError(f"unknown statement {op}")

    def assign(self, target, value, env):
        if target[0] == "name":
            name = target[1]
            scope = env.lookup(name)
            if scope is not None:
                scope.vars[name] = value
            else:
                self.globals.set(name, value)
        elif target[0] == "index":
            obj = self.eval(target[1], env)
            key = self.eval(target[2], env)
            self.setindex(obj, key, value)
        else:
            raise LuaError(f"cannot assign to {target[0]}")

    def setindex(self, obj, key, value):
        if isinstance(obj, LuaTable):
            if obj.get(key) is None and obj.metatable is not None:
                newindex = obj.metatable.get("__newindex")
                if newindex is not None:
                    if isinstance(newindex, LuaTable):
                        return self.setindex(newindex, key, value)
                    self.call(newindex, [obj, key, value])
                    return
            obj.set(key, value)
            return
        raise LuaError(f"attempt to index a {type(obj).__name__} value")

    # --- expressions ------------------------------------------------------
    def eval_list(self, exprs, env, want):
        """Evaluate an expression list with Lua multi-value semantics.
        ``want=None`` returns all values."""
        values = []
        for i, expr in enumerate(exprs):
            if i == len(exprs) - 1:
                values.extend(self.eval_multi(expr, env))
            else:
                values.append(self.eval(expr, env))
        if want is not None:
            while len(values) < want:
                values.append(None)
            values = values[:want]
        return values

    def eval_multi(self, expr, env):
        """Evaluate, preserving multiple return values (returns a list)."""
        op = expr[0]
        if op == "call":
            func = self.eval(expr[1], env)
            args = self.eval_list(expr[2], env, None)
            return self.call(func, args)
        if op == "method":
            obj = self.eval(expr[1], env)
            func = self.getindex(obj, expr[2])
            if func is None:
                raise LuaError(f"attempt to call missing method '{expr[2]}'")
            args = self.eval_list(expr[3], env, None)
            return self.call(func, [obj] + args)
        if op == "vararg":
            scope = env.lookup("...")
            return list(scope.vars["..."]) if scope else []
        return [self.eval(expr, env)]

    def eval(self, expr, env):
        op = expr[0]
        if op == "num":
            return expr[1]
        if op == "str":
            return expr[1]
        if op == "nil":
            return None
        if op == "true":
            return True
        if op == "false":
            return False
        if op == "name":
            scope = env.lookup(expr[1])
            if scope is not None:
                return scope.vars[expr[1]]
            return self.globals.get(expr[1])
        if op == "paren":
            return self.eval(expr[1], env)
        if op == "index":
            obj = self.eval(expr[1], env)
            key = self.eval(expr[2], env)
            return self.getindex(obj, key)
        if op in ("call", "method", "vararg"):
            values = self.eval_multi(expr, env)
            return values[0] if values else None
        if op == "func":
            _, params, is_vararg, body = expr
            return LuaFunction(params, is_vararg, body, env, self)
        if op == "table":
            _, array_items, hash_items = expr
            table = LuaTable()
            idx = 1
            for i, item in enumerate(array_items):
                if i == len(array_items) - 1:
                    for v in self.eval_multi(item, env):
                        table.set(float(idx), v)
                        idx += 1
                else:
                    table.set(float(idx), self.eval(item, env))
                    idx += 1
            for key_expr, val_expr in hash_items:
                table.set(self.eval(key_expr, env), self.eval(val_expr, env))
            return table
        if op == "binop":
            return self.eval_binop(expr[1], expr[2], expr[3], env)
        if op == "unop":
            return self.eval_unop(expr[1], expr[2], env)
        raise LuaError(f"unknown expression {op}")

    def getindex(self, obj, key):
        if isinstance(obj, LuaTable):
            value = obj.get(key)
            if value is not None:
                return value
            if obj.metatable is not None:
                index = obj.metatable.get("__index")
                if index is not None:
                    if isinstance(index, LuaTable):
                        return self.getindex(index, key)
                    result = self.call(index, [obj, key])
                    return result[0] if result else None
            return None
        if isinstance(obj, str):
            strlib = self.globals.get("string")
            if strlib is not None:
                return strlib.get(key)
            return None
        if obj is None:
            raise LuaError(f"attempt to index a nil value (key {key!r})")
        raise LuaError(f"attempt to index a {type(obj).__name__} value")

    def tonumber(self, value, what="value"):
        if isinstance(value, bool):
            raise LuaError(f"{what}: attempt to perform arithmetic on a boolean")
        if isinstance(value, float):
            return value
        if isinstance(value, int):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
        raise LuaError(f"{what}: attempt to perform arithmetic on {type(value).__name__}")

    def _metabinop(self, event, lhs, rhs):
        for operand in (lhs, rhs):
            if isinstance(operand, LuaTable) and operand.metatable is not None:
                handler = operand.metatable.get(event)
                if handler is not None:
                    result = self.call(handler, [lhs, rhs])
                    return True, (result[0] if result else None)
        return False, None

    ARITH = {
        "+": ("__add", lambda a, b: a + b),
        "-": ("__sub", lambda a, b: a - b),
        "*": ("__mul", lambda a, b: a * b),
        "/": ("__div", lambda a, b: a / b),
        "//": ("__idiv", lambda a, b: float(a // b)),
        "%": ("__mod", lambda a, b: a - (a // b) * b),
        "^": ("__pow", lambda a, b: a ** b),
    }

    def eval_binop(self, op, lhs_expr, rhs_expr, env):
        if op == "and":
            lhs = self.eval(lhs_expr, env)
            return self.eval(rhs_expr, env) if is_truthy(lhs) else lhs
        if op == "or":
            lhs = self.eval(lhs_expr, env)
            return lhs if is_truthy(lhs) else self.eval(rhs_expr, env)

        lhs = self.eval(lhs_expr, env)
        rhs = self.eval(rhs_expr, env)

        if op in self.ARITH:
            event, fn = self.ARITH[op]
            if isinstance(lhs, (int, float)) and not isinstance(lhs, bool) and \
               isinstance(rhs, (int, float)) and not isinstance(rhs, bool):
                return float(fn(float(lhs), float(rhs)))
            handled, result = self._metabinop(event, lhs, rhs)
            if handled:
                return result
            return float(fn(self.tonumber(lhs), self.tonumber(rhs)))
        if op == "..":
            if isinstance(lhs, (str, float)) and isinstance(rhs, (str, float)):
                return lua_tostring(lhs) + lua_tostring(rhs)
            handled, result = self._metabinop("__concat", lhs, rhs)
            if handled:
                return result
            raise LuaError("attempt to concatenate incompatible values")
        if op == "==":
            return self._equals(lhs, rhs)
        if op == "~=":
            return not self._equals(lhs, rhs)
        if op in ("<", "<=", ">", ">="):
            if op == ">":
                lhs, rhs, op = rhs, lhs, "<"
            elif op == ">=":
                lhs, rhs, op = rhs, lhs, "<="
            if isinstance(lhs, float) and isinstance(rhs, float):
                return lhs < rhs if op == "<" else lhs <= rhs
            if isinstance(lhs, str) and isinstance(rhs, str):
                return lhs < rhs if op == "<" else lhs <= rhs
            handled, result = self._metabinop("__lt" if op == "<" else "__le", lhs, rhs)
            if handled:
                return is_truthy(result)
            raise LuaError("attempt to compare incompatible values")
        raise LuaError(f"unknown operator {op}")

    def _equals(self, lhs, rhs):
        if type(lhs) is not type(rhs):
            # numbers compare across int/float, everything else by type
            if isinstance(lhs, float) and isinstance(rhs, float):
                return lhs == rhs
            return False
        if isinstance(lhs, LuaTable):
            if lhs is rhs:
                return True
            handled, result = self._metabinop("__eq", lhs, rhs)
            return is_truthy(result) if handled else False
        return lhs == rhs

    def eval_unop(self, op, expr, env):
        value = self.eval(expr, env)
        if op == "-":
            if isinstance(value, float):
                return -value
            if isinstance(value, LuaTable) and value.metatable is not None:
                handler = value.metatable.get("__unm")
                if handler is not None:
                    result = self.call(handler, [value, value])
                    return result[0] if result else None
            return -self.tonumber(value)
        if op == "not":
            return not is_truthy(value)
        if op == "#":
            if isinstance(value, str):
                return float(len(value))
            if isinstance(value, LuaTable):
                if value.metatable is not None:
                    handler = value.metatable.get("__len")
                    if handler is not None:
                        result = self.call(handler, [value])
                        return result[0] if result else None
                return float(value.lua_len())
            raise LuaError("attempt to get length of incompatible value")
        raise LuaError(f"unknown unary operator {op}")
