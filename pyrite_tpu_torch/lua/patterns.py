"""Lua 5.1 string patterns (the reference embeds real Lua via mlua, so
user scenes may rely on the full pattern language; lstrlib semantics,
written from scratch against the Lua reference manual §5.4.1).

Supports: character classes (%a %c %d %l %p %s %u %w %x %z and their
complements), `.`, sets ``[...]`` with ranges and ``^`` complement,
quantifiers ``* + - ?``, anchors ``^ $``, captures (including position
captures ``()``), back-references ``%1``-``%9``, and balanced matches
``%bxy``. Indices are 0-based internally; the stdlib shims convert to
Lua's 1-based convention."""

from __future__ import annotations

from .interpreter import LuaError

_SPECIALS = "^$*+?.([%-"
_MAX_CAPTURES = 32
_CAP_POSITION = -2  # sentinel length: position capture
_CAP_UNFINISHED = -1


class _MatchState:
    __slots__ = ("src", "pat", "caps")

    def __init__(self, src: str, pat: str):
        self.src = src
        self.pat = pat
        self.caps = []  # list of [start, len] (len may be sentinel)


def _class_match(c: str, cl: str) -> bool:
    """Single-character class test (%a etc.). An upper-case class letter
    is the complement."""
    low = cl.lower()
    if low == "a":
        res = c.isalpha()
    elif low == "c":
        res = ord(c) < 32 or ord(c) == 127
    elif low == "d":
        res = c.isdigit()
    elif low == "l":
        res = c.islower()
    elif low == "p":
        res = (33 <= ord(c) <= 47 or 58 <= ord(c) <= 64
               or 91 <= ord(c) <= 96 or 123 <= ord(c) <= 126)
    elif low == "s":
        res = c in " \t\n\r\f\v"
    elif low == "u":
        res = c.isupper()
    elif low == "w":
        res = c.isalnum()
    elif low == "x":
        res = c in "0123456789abcdefABCDEF"
    elif low == "z":
        res = c == "\0"
    else:
        return c == cl
    return res != cl.isupper()


def _class_end(ms: _MatchState, p: int) -> int:
    """Index just past the pattern item starting at p (a single class)."""
    pat = ms.pat
    c = pat[p]
    p += 1
    if c == "%":
        if p >= len(pat):
            raise LuaError("malformed pattern (ends with '%')")
        return p + 1
    if c == "[":
        if p < len(pat) and pat[p] == "^":
            p += 1
        # the first ']' is a literal member
        first = True
        while True:
            if p >= len(pat):
                raise LuaError("malformed pattern (missing ']')")
            ch = pat[p]
            p += 1
            if ch == "%":
                if p >= len(pat):
                    raise LuaError("malformed pattern (ends with '%')")
                p += 1
            elif ch == "]" and not first:
                return p
            first = False
    return p


def _set_match(ms: _MatchState, c: str, p: int, ep: int) -> bool:
    """Match c against the set pattern at pat[p:ep] (p points at '[')."""
    pat = ms.pat
    p += 1
    negate = False
    if pat[p] == "^":
        negate = True
        p += 1
    res = False
    while p < ep - 1:
        if pat[p] == "%":
            p += 1
            if _class_match(c, pat[p]):
                res = True
            p += 1
        elif p + 2 < ep - 1 and pat[p + 1] == "-":
            if pat[p] <= c <= pat[p + 2]:
                res = True
            p += 3
        else:
            if pat[p] == c:
                res = True
            p += 1
    return res != negate


def _single_match(ms: _MatchState, s: int, p: int, ep: int) -> bool:
    if s >= len(ms.src):
        return False
    c = ms.src[s]
    pc = ms.pat[p]
    if pc == ".":
        return True
    if pc == "%":
        return _class_match(c, ms.pat[p + 1])
    if pc == "[":
        return _set_match(ms, c, p, ep)
    return pc == c


def _match_balance(ms: _MatchState, s: int, p: int):
    pat = ms.pat
    if p + 1 >= len(pat):
        raise LuaError("missing arguments to '%b'")
    if s >= len(ms.src) or ms.src[s] != pat[p]:
        return None
    b, e = pat[p], pat[p + 1]
    cont = 1
    i = s + 1
    while i < len(ms.src):
        if ms.src[i] == e:
            cont -= 1
            if cont == 0:
                return i + 1
        elif ms.src[i] == b:
            cont += 1
        i += 1
    return None


def _match_capture(ms: _MatchState, s: int, idx: int):
    idx -= 1
    if idx < 0 or idx >= len(ms.caps) or ms.caps[idx][1] == _CAP_UNFINISHED:
        raise LuaError(f"invalid capture index %{idx + 1}")
    start, length = ms.caps[idx]
    cap = ms.src[start : start + length]
    if ms.src.startswith(cap, s):
        return s + len(cap)
    return None


def _match(ms: _MatchState, s: int, p: int):
    """Backtracking matcher: returns the end index in src or None."""
    pat = ms.pat
    while True:
        if p >= len(pat):
            return s
        c = pat[p]
        if c == "(":
            if p + 1 < len(pat) and pat[p + 1] == ")":
                ms.caps.append([s, _CAP_POSITION])
                r = _match(ms, s, p + 2)
                if r is None:
                    ms.caps.pop()
                return r
            ms.caps.append([s, _CAP_UNFINISHED])
            r = _match(ms, s, p + 1)
            if r is None:
                ms.caps.pop()
            return r
        if c == ")":
            for cap in reversed(ms.caps):
                if cap[1] == _CAP_UNFINISHED:
                    cap[1] = s - cap[0]
                    r = _match(ms, s, p + 1)
                    if r is None:
                        cap[1] = _CAP_UNFINISHED
                    return r
            raise LuaError("invalid pattern capture")
        if c == "$" and p + 1 == len(pat):
            return s if s == len(ms.src) else None
        if c == "%":
            nxt = pat[p + 1] if p + 1 < len(pat) else ""
            if nxt == "b":
                r = _match_balance(ms, s, p + 2)
                if r is None:
                    return None
                s = r
                p += 4
                continue
            if nxt == "f":
                p += 2
                if p >= len(pat) or pat[p] != "[":
                    raise LuaError("missing '[' after '%f' in pattern")
                ep = _class_end(ms, p)
                prev = ms.src[s - 1] if s > 0 else "\0"
                cur = ms.src[s] if s < len(ms.src) else "\0"
                if not _set_match(ms, prev, p, ep) and _set_match(ms, cur, p, ep):
                    p = ep
                    continue
                return None
            if nxt.isdigit():
                r = _match_capture(ms, s, int(nxt))
                if r is None:
                    return None
                s = r
                p += 2
                continue
        ep = _class_end(ms, p)
        suffix = pat[ep] if ep < len(pat) else ""
        if suffix == "?":
            if _single_match(ms, s, p, ep):
                r = _match(ms, s + 1, ep + 1)
                if r is not None:
                    return r
            p = ep + 1
            continue
        if suffix == "+":
            if not _single_match(ms, s, p, ep):
                return None
            s += 1
            # fall through to max-expand
            count = 0
            while _single_match(ms, s + count, p, ep):
                count += 1
            while count >= 0:
                r = _match(ms, s + count, ep + 1)
                if r is not None:
                    return r
                count -= 1
            return None
        if suffix == "*":
            count = 0
            while _single_match(ms, s + count, p, ep):
                count += 1
            while count >= 0:
                r = _match(ms, s + count, ep + 1)
                if r is not None:
                    return r
                count -= 1
            return None
        if suffix == "-":
            while True:
                r = _match(ms, s, ep + 1)
                if r is not None:
                    return r
                if _single_match(ms, s, p, ep):
                    s += 1
                else:
                    return None
        if not _single_match(ms, s, p, ep):
            return None
        s += 1
        p = ep


def _captures(ms: _MatchState, s: int, e: int, whole_if_none=True):
    """Extracted capture values (Lua convention: position captures are
    1-based numbers; no captures -> the whole match when asked)."""
    if not ms.caps:
        return [ms.src[s:e]] if whole_if_none else []
    out = []
    for start, length in ms.caps:
        if length == _CAP_POSITION:
            out.append(float(start + 1))
        else:
            out.append(ms.src[start : start + length])
    return out


def pattern_find(s: str, pat: str, init: int = 0):
    """Lowest-level find: returns (start, end, captures) 0-based-end-exclusive
    or None. ``init`` is a 0-based start offset."""
    anchored = pat.startswith("^")
    p0 = 1 if anchored else 0
    idx = init
    while True:
        ms = _MatchState(s, pat)
        e = _match(ms, idx, p0)
        if e is not None:
            return idx, e, _captures(ms, idx, e, whole_if_none=False)
        if anchored or idx >= len(s):
            return None
        idx += 1


def pattern_match(s: str, pat: str, init: int = 0):
    """Returns the capture list (whole match if no captures) or None."""
    anchored = pat.startswith("^")
    p0 = 1 if anchored else 0
    idx = init
    while True:
        ms = _MatchState(s, pat)
        e = _match(ms, idx, p0)
        if e is not None:
            return _captures(ms, idx, e)
        if anchored or idx >= len(s):
            return None
        idx += 1


def pattern_gmatch(s: str, pat: str):
    """Iterator of capture lists over successive matches (gmatch ignores
    a leading ^ anchor per Lua 5.1)."""
    idx = 0
    while idx <= len(s):
        ms = _MatchState(s, pat)
        e = _match(ms, idx, 0)
        if e is not None:
            yield _captures(ms, idx, e)
            idx = e + 1 if e == idx else e  # never loop on empty matches
        else:
            idx += 1


def pattern_gsub(s: str, pat: str, repl, max_n=None, call=None):
    """Global substitution. ``repl`` is a string (%0-%9 escapes), a dict-like
    with .get (LuaTable), or a callable invoked through ``call`` with the
    captures; falsy/None results keep the original match."""
    anchored = pat.startswith("^")
    p0 = 1 if anchored else 0
    out = []
    idx = 0
    count = 0
    while idx <= len(s) and (max_n is None or count < max_n):
        ms = _MatchState(s, pat)
        e = _match(ms, idx, p0)
        if e is not None:
            count += 1
            whole = s[idx:e]
            caps = _captures(ms, idx, e)
            if isinstance(repl, str):
                rep = []
                i = 0
                while i < len(repl):
                    ch = repl[i]
                    if ch == "%" and i + 1 < len(repl):
                        d = repl[i + 1]
                        if d == "%":
                            rep.append("%")
                        elif d == "0":
                            rep.append(whole)
                        elif d.isdigit():
                            k = int(d) - 1
                            if k >= len(caps):
                                raise LuaError(f"invalid capture index %{d}")
                            v = caps[k]
                            rep.append(v if isinstance(v, str) else _numstr(v))
                        else:
                            raise LuaError("invalid use of '%' in replacement string")
                        i += 2
                    else:
                        rep.append(ch)
                        i += 1
                out.append("".join(rep))
            else:
                value = call(repl, caps)
                if value is None or value is False:
                    out.append(whole)
                else:
                    out.append(value if isinstance(value, str) else _numstr(value))
            if e == idx:  # empty match: consume one char to advance
                if idx < len(s):
                    out.append(s[idx])
                idx += 1
            else:
                idx = e
        else:
            if idx < len(s):
                out.append(s[idx])
            idx += 1
        if anchored:
            break
    out.append(s[idx:])
    return "".join(out), count


def _numstr(x) -> str:
    f = float(x)
    return str(int(f)) if f == int(f) else repr(f)
