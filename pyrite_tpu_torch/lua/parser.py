"""Recursive-descent parser producing a tuple-based Lua AST."""

from __future__ import annotations

from .lexer import Token, tokenize, LuaSyntaxError

# (precedence_left, precedence_right); right-assoc ops have right < left
BINOP_PRI = {
    "or": (1, 1),
    "and": (2, 2),
    "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3), "~=": (3, 3), "==": (3, 3),
    "..": (9, 8),  # right associative
    "+": (10, 10), "-": (10, 10),
    "*": (11, 11), "/": (11, 11), "//": (11, 11), "%": (11, 11),
    "^": (14, 13),  # right associative
}
UNARY_PRI = 12


class Parser:
    def __init__(self, src: str, chunk_name: str = "?"):
        self.tokens = tokenize(src, chunk_name)
        self.pos = 0
        self.chunk = chunk_name

    # --- token helpers -----------------------------------------------------
    def peek(self) -> Token:
        return self.tokens[self.pos]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def check(self, kind, value=None) -> bool:
        tok = self.peek()
        return tok.kind == kind and (value is None or tok.value == value)

    def accept(self, kind, value=None):
        if self.check(kind, value):
            return self.next()
        return None

    def expect(self, kind, value=None) -> Token:
        tok = self.peek()
        if not self.check(kind, value):
            raise LuaSyntaxError(
                f"{self.chunk}:{tok.line}: expected {value or kind}, got {tok.kind} {tok.value!r}"
            )
        return self.next()

    # --- entry -------------------------------------------------------------
    def parse_chunk(self):
        body = self.parse_block()
        self.expect("eof")
        return body

    def parse_block(self):
        stmts = []
        while True:
            if self.accept("symbol", ";"):
                continue
            tok = self.peek()
            if tok.kind == "eof":
                break
            if tok.kind == "keyword" and tok.value in (
                "end", "else", "elseif", "until",
            ):
                break
            if tok.kind == "keyword" and tok.value == "return":
                self.next()
                exprs = []
                if not (
                    self.peek().kind == "eof"
                    or self.check("symbol", ";")
                    or (self.peek().kind == "keyword"
                        and self.peek().value in ("end", "else", "elseif", "until"))
                ):
                    exprs = self.parse_exprlist()
                self.accept("symbol", ";")
                stmts.append(("return", exprs))
                break
            stmts.append(self.parse_statement())
        return stmts

    # --- statements --------------------------------------------------------
    def parse_statement(self):
        tok = self.peek()
        if tok.kind == "keyword":
            kw = tok.value
            if kw == "local":
                self.next()
                if self.accept("keyword", "function"):
                    name = self.expect("name").value
                    func = self.parse_funcbody()
                    return ("localfunc", name, func)
                names = [self.expect("name").value]
                while self.accept("symbol", ","):
                    names.append(self.expect("name").value)
                exprs = []
                if self.accept("symbol", "="):
                    exprs = self.parse_exprlist()
                return ("local", names, exprs)
            if kw == "if":
                self.next()
                clauses = []
                cond = self.parse_expr()
                self.expect("keyword", "then")
                clauses.append((cond, self.parse_block()))
                else_body = []
                while True:
                    if self.accept("keyword", "elseif"):
                        cond = self.parse_expr()
                        self.expect("keyword", "then")
                        clauses.append((cond, self.parse_block()))
                    elif self.accept("keyword", "else"):
                        else_body = self.parse_block()
                        self.expect("keyword", "end")
                        break
                    else:
                        self.expect("keyword", "end")
                        break
                return ("if", clauses, else_body)
            if kw == "while":
                self.next()
                cond = self.parse_expr()
                self.expect("keyword", "do")
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("while", cond, body)
            if kw == "repeat":
                self.next()
                body = self.parse_block()
                self.expect("keyword", "until")
                cond = self.parse_expr()
                return ("repeat", body, cond)
            if kw == "for":
                self.next()
                first = self.expect("name").value
                if self.accept("symbol", "="):
                    start = self.parse_expr()
                    self.expect("symbol", ",")
                    stop = self.parse_expr()
                    step = None
                    if self.accept("symbol", ","):
                        step = self.parse_expr()
                    self.expect("keyword", "do")
                    body = self.parse_block()
                    self.expect("keyword", "end")
                    return ("fornum", first, start, stop, step, body)
                names = [first]
                while self.accept("symbol", ","):
                    names.append(self.expect("name").value)
                self.expect("keyword", "in")
                exprs = self.parse_exprlist()
                self.expect("keyword", "do")
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("forin", names, exprs, body)
            if kw == "function":
                self.next()
                target = ("name", self.expect("name").value)
                is_method = False
                while True:
                    if self.accept("symbol", "."):
                        target = ("index", target, ("str", self.expect("name").value))
                    elif self.accept("symbol", ":"):
                        target = ("index", target, ("str", self.expect("name").value))
                        is_method = True
                        break
                    else:
                        break
                func = self.parse_funcbody(is_method=is_method)
                return ("assign", [target], [func])
            if kw == "do":
                self.next()
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("do", body)
            if kw == "break":
                self.next()
                return ("break",)
            if kw == "goto":
                self.next()
                return ("goto", self.expect("name").value)
        if tok.kind == "symbol" and tok.value == "::":
            self.next()
            name = self.expect("name").value
            self.expect("symbol", "::")
            return ("label", name)
        # expression statement: call or assignment
        expr = self.parse_suffixed()
        if self.check("symbol", "=") or self.check("symbol", ","):
            targets = [expr]
            while self.accept("symbol", ","):
                targets.append(self.parse_suffixed())
            self.expect("symbol", "=")
            exprs = self.parse_exprlist()
            for t in targets:
                if t[0] not in ("name", "index"):
                    raise LuaSyntaxError(f"{self.chunk}: cannot assign to {t[0]}")
            return ("assign", targets, exprs)
        if expr[0] not in ("call", "method"):
            raise LuaSyntaxError(f"{self.chunk}:{tok.line}: syntax error near {tok.value!r}")
        return ("callstat", expr)

    # --- expressions -------------------------------------------------------
    def parse_exprlist(self):
        exprs = [self.parse_expr()]
        while self.accept("symbol", ","):
            exprs.append(self.parse_expr())
        return exprs

    def parse_expr(self, limit=0):
        tok = self.peek()
        if tok.kind == "keyword" and tok.value == "not":
            self.next()
            left = ("unop", "not", self.parse_expr(UNARY_PRI))
        elif tok.kind == "symbol" and tok.value == "-":
            self.next()
            left = ("unop", "-", self.parse_expr(UNARY_PRI))
        elif tok.kind == "symbol" and tok.value == "#":
            self.next()
            left = ("unop", "#", self.parse_expr(UNARY_PRI))
        else:
            left = self.parse_simple()
        while True:
            tok = self.peek()
            op = None
            if tok.kind == "symbol" and tok.value in BINOP_PRI:
                op = tok.value
            elif tok.kind == "keyword" and tok.value in ("and", "or"):
                op = tok.value
            if op is None:
                break
            lpri, rpri = BINOP_PRI[op]
            if lpri <= limit:
                break
            self.next()
            right = self.parse_expr(rpri)
            left = ("binop", op, left, right)
        return left

    def parse_simple(self):
        tok = self.peek()
        if tok.kind == "number":
            self.next()
            return ("num", tok.value)
        if tok.kind == "string":
            self.next()
            return ("str", tok.value)
        if tok.kind == "keyword":
            if tok.value == "nil":
                self.next()
                return ("nil",)
            if tok.value == "true":
                self.next()
                return ("true",)
            if tok.value == "false":
                self.next()
                return ("false",)
            if tok.value == "function":
                self.next()
                return self.parse_funcbody()
        if tok.kind == "symbol":
            if tok.value == "...":
                self.next()
                return ("vararg",)
            if tok.value == "{":
                return self.parse_table()
        return self.parse_suffixed()

    def parse_primary(self):
        tok = self.peek()
        if tok.kind == "name":
            self.next()
            return ("name", tok.value)
        if tok.kind == "symbol" and tok.value == "(":
            self.next()
            expr = self.parse_expr()
            self.expect("symbol", ")")
            return ("paren", expr)
        raise LuaSyntaxError(
            f"{self.chunk}:{tok.line}: unexpected {tok.kind} {tok.value!r}"
        )

    def parse_suffixed(self):
        expr = self.parse_primary()
        while True:
            tok = self.peek()
            if tok.kind == "symbol" and tok.value == ".":
                self.next()
                expr = ("index", expr, ("str", self.expect("name").value))
            elif tok.kind == "symbol" and tok.value == "[":
                self.next()
                key = self.parse_expr()
                self.expect("symbol", "]")
                expr = ("index", expr, key)
            elif tok.kind == "symbol" and tok.value == ":":
                self.next()
                name = self.expect("name").value
                args = self.parse_callargs()
                expr = ("method", expr, name, args)
            elif (tok.kind == "symbol" and tok.value in ("(", "{")) or tok.kind == "string":
                args = self.parse_callargs()
                expr = ("call", expr, args)
            else:
                return expr

    def parse_callargs(self):
        tok = self.peek()
        if tok.kind == "string":
            self.next()
            return [("str", tok.value)]
        if tok.kind == "symbol" and tok.value == "{":
            return [self.parse_table()]
        self.expect("symbol", "(")
        args = []
        if not self.check("symbol", ")"):
            args = self.parse_exprlist()
        self.expect("symbol", ")")
        return args

    def parse_table(self):
        self.expect("symbol", "{")
        array_items = []
        hash_items = []
        while not self.check("symbol", "}"):
            tok = self.peek()
            if tok.kind == "symbol" and tok.value == "[":
                self.next()
                key = self.parse_expr()
                self.expect("symbol", "]")
                self.expect("symbol", "=")
                hash_items.append((key, self.parse_expr()))
            elif tok.kind == "name" and self.tokens[self.pos + 1].kind == "symbol" \
                    and self.tokens[self.pos + 1].value == "=":
                self.next()
                self.next()
                hash_items.append((("str", tok.value), self.parse_expr()))
            else:
                array_items.append(self.parse_expr())
            if not (self.accept("symbol", ",") or self.accept("symbol", ";")):
                break
        self.expect("symbol", "}")
        return ("table", array_items, hash_items)

    def parse_funcbody(self, is_method=False):
        self.expect("symbol", "(")
        params = ["self"] if is_method else []
        is_vararg = False
        if not self.check("symbol", ")"):
            while True:
                if self.accept("symbol", "..."):
                    is_vararg = True
                    break
                params.append(self.expect("name").value)
                if not self.accept("symbol", ","):
                    break
        self.expect("symbol", ")")
        body = self.parse_block()
        self.expect("keyword", "end")
        return ("func", params, is_vararg, body)


def parse(src: str, chunk_name: str = "?"):
    return Parser(src, chunk_name).parse_chunk()
