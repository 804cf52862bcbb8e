"""Lua tokenizer."""

from __future__ import annotations

from dataclasses import dataclass

KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for", "function",
    "goto", "if", "in", "local", "nil", "not", "or", "repeat", "return",
    "then", "true", "until", "while",
}

# Longest-first so the scanner can greedily match.
SYMBOLS = [
    "...", "..", ".", "==", "~=", "<=", ">=", "<", ">", "=", "+", "-", "*",
    "//", "/", "%", "^", "#", "(", ")", "{", "}", "[", "]", ";", "::", ":",
    ",",
]


@dataclass
class Token:
    kind: str  # 'name' | 'number' | 'string' | 'keyword' | 'symbol' | 'eof'
    value: object
    line: int


class LuaSyntaxError(SyntaxError):
    pass


def tokenize(src: str, chunk_name: str = "?") -> list[Token]:
    tokens: list[Token] = []
    i = 0
    line = 1
    n = len(src)

    def err(msg):
        raise LuaSyntaxError(f"{chunk_name}:{line}: {msg}")

    def read_long_bracket(start: int):
        """Parse [=*[ ... ]=*] starting at ``start``. Returns (content, end)
        or None if not a long bracket."""
        nonlocal line
        j = start + 1
        level = 0
        while j < n and src[j] == "=":
            level += 1
            j += 1
        if j >= n or src[j] != "[":
            return None
        j += 1
        if j < n and src[j] == "\n":
            line += 1
            j += 1
        close = "]" + "=" * level + "]"
        end = src.find(close, j)
        if end < 0:
            err("unterminated long bracket")
        content = src[j:end]
        line_count = content.count("\n")
        line += line_count
        return content, end + len(close)

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        # comments
        if src.startswith("--", i):
            if i + 2 < n and src[i + 2] == "[":
                lb = read_long_bracket(i + 2)
                if lb is not None:
                    i = lb[1]
                    continue
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        # long string
        if c == "[" and i + 1 < n and src[i + 1] in "[=":
            lb = read_long_bracket(i)
            if lb is not None:
                tokens.append(Token("string", lb[0], line))
                i = lb[1]
                continue
        # strings
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    err("unterminated string")
                ch = src[j]
                if ch == quote:
                    j += 1
                    break
                if ch == "\n":
                    err("unterminated string")
                if ch == "\\":
                    j += 1
                    if j >= n:
                        err("unterminated string escape")
                    esc = src[j]
                    mapping = {
                        "n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
                        "f": "\f", "v": "\v", "\\": "\\", '"': '"', "'": "'",
                        "\n": "\n",
                    }
                    if esc in mapping:
                        buf.append(mapping[esc])
                        if esc == "\n":
                            line += 1
                        j += 1
                    elif esc.isdigit():
                        num = esc
                        j += 1
                        while j < n and src[j].isdigit() and len(num) < 3:
                            num += src[j]
                            j += 1
                        buf.append(chr(int(num)))
                    elif esc == "x":
                        buf.append(chr(int(src[j + 1 : j + 3], 16)))
                        j += 3
                    elif esc == "z":
                        j += 1
                        while j < n and src[j] in " \t\r\n":
                            if src[j] == "\n":
                                line += 1
                            j += 1
                    else:
                        err(f"invalid escape '\\{esc}'")
                else:
                    buf.append(ch)
                    j += 1
            tokens.append(Token("string", "".join(buf), line))
            i = j
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and (src[j] in "0123456789abcdefABCDEF.pP" or
                                 (src[j] in "+-" and src[j - 1] in "pP")):
                    j += 1
                text = src[i:j]
                value = float.fromhex(text) if ("." in text or "p" in text.lower()) else float(int(text, 16))
            else:
                while j < n and (src[j].isdigit() or src[j] in ".eE" or
                                 (src[j] in "+-" and src[j - 1] in "eE")):
                    j += 1
                value = float(src[i:j])
            tokens.append(Token("number", value, line))
            i = j
            continue
        # names / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            tokens.append(Token("keyword" if word in KEYWORDS else "name", word, line))
            i = j
            continue
        # symbols
        for sym in SYMBOLS:
            if src.startswith(sym, i):
                tokens.append(Token("symbol", sym, line))
                i += len(sym)
                break
        else:
            err(f"unexpected character {c!r}")

    tokens.append(Token("eof", None, line))
    return tokens
