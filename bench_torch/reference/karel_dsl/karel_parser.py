"""Recursive-descent parser: Karel token sequence -> AST.

The benchmark's copy of demo2program_tpu_torch/dsl/karel_parser.py, frozen
with the yardstick: the plain reference scores programs with it, so a
later change to the program's DSL code cannot move the reference.

Behavioural parity target: `karel_env/dsl/dsl_parse.py:250-263` — the
reference's shift-reduce parser. API mirrors its ``parse(program_str) ->
(result, ok)`` contract: on any syntax error we return ``(None, False)``
instead of raising.

Statement sequences are folded LEFT (``((a b) c)``) to match the reference's
eager reduction order; see karel_ast.py.
"""

from bench_torch.reference.karel_dsl import karel_ast as A
from bench_torch.reference.karel_dsl.karel_vocab import (
    ACTION_TOKENS, PERCEPT_TOKENS, MIN_INT, MAX_INT, INT_PREFIX,
)

_ACTIONS = set(ACTION_TOKENS)
_PERCEPTS = set(PERCEPT_TOKENS)
# tokens that can start a statement
_STMT_STARTS = _ACTIONS | {"WHILE", "REPEAT", "IF", "IFELSE"}


class _SyntaxError(Exception):
    pass


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def eat(self, expected=None):
        t = self.peek()
        if t is None or (expected is not None and t != expected):
            raise _SyntaxError(f"expected {expected!r}, got {t!r}")
        self.i += 1
        return t

    def parse_program(self):
        self.eat("DEF")
        self.eat("run")
        self.eat("m(")
        body = self.parse_stmt_seq("m)")
        self.eat("m)")
        if self.peek() is not None:
            raise _SyntaxError("trailing tokens after program")
        return A.Program(body)

    def parse_stmt_seq(self, closing):
        """Parse one-or-more statements until `closing`; left-fold into Seq."""
        node = self.parse_one_stmt()
        while self.peek() is not None and self.peek() != closing:
            nxt = self.parse_one_stmt()
            node = A.Seq(node, nxt)
        return node

    def parse_one_stmt(self):
        t = self.peek()
        if t in _ACTIONS:
            self.eat()
            return A.Action(t)
        if t == "WHILE":
            self.eat()
            self.eat("c(")
            cond = self.parse_cond()
            self.eat("c)")
            self.eat("w(")
            body = self.parse_stmt_seq("w)")
            self.eat("w)")
            return A.While(cond, body)
        if t == "REPEAT":
            self.eat()
            count = self.parse_cste()
            self.eat("r(")
            body = self.parse_stmt_seq("r)")
            self.eat("r)")
            return A.Repeat(count, body)
        if t == "IF":
            self.eat()
            self.eat("c(")
            cond = self.parse_cond()
            self.eat("c)")
            self.eat("i(")
            body = self.parse_stmt_seq("i)")
            self.eat("i)")
            return A.If(cond, body)
        if t == "IFELSE":
            self.eat()
            self.eat("c(")
            cond = self.parse_cond()
            self.eat("c)")
            self.eat("i(")
            body = self.parse_stmt_seq("i)")
            self.eat("i)")
            self.eat("ELSE")
            self.eat("e(")
            else_body = self.parse_stmt_seq("e)")
            self.eat("e)")
            return A.IfElse(cond, body, else_body)
        raise _SyntaxError(f"unexpected token {t!r} at statement start")

    def parse_cond(self):
        t = self.peek()
        if t == "not":
            # `not c( cond c)` — the reference's RUNTIME parser rule
            # (`dsl_parse.py:139`) allows NESTED not-conditions, even though
            # the PLY sampling grammar (`dsl_prob.py:217-220`) never emits
            # them. Syntax accuracy is judged by the runtime parser
            # (`model_full.py:602-616`), so we accept nesting too.
            self.eat()
            self.eat("c(")
            inner = self.parse_cond()
            self.eat("c)")
            return A.Not(inner)
        return self.parse_percept()

    def parse_percept(self):
        t = self.eat()
        if t not in _PERCEPTS:
            raise _SyntaxError(f"expected perception token, got {t!r}")
        return A.Percept(t)

    def parse_cste(self):
        t = self.eat()
        if not t.startswith(INT_PREFIX):
            raise _SyntaxError(f"expected {INT_PREFIX}<n>, got {t!r}")
        try:
            value = int(t[len(INT_PREFIX):])
        except ValueError:
            raise _SyntaxError(f"bad integer token {t!r}")
        if not (MIN_INT <= value <= MAX_INT):
            raise _SyntaxError(f"integer out of range: {t!r}")
        return value


def parse(program, want_ast=True):
    """Parse a program string (or token list) -> (ast_or_None, ok)."""
    tokens = program.split() if isinstance(program, str) else list(program)
    try:
        ast = _Parser(tokens).parse_program()
    except _SyntaxError:
        return None, False
    return (ast if want_ast else None), True
