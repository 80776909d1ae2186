"""Recursive-descent parser for the ViZDoom DSL.

The port's own copy of demo2program_tpu/dsl/vizdoom_parser.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Behavioural parity: `vizdoom_env/dsl/dsl_parse.py:262-304` (shift-reduce,
eager left-fold of statement sequences, nested not allowed via the
`not c( cond c)` rule over 'cond'). Returns (ast_or_None, ok)."""

from demo2program_tpu_torch.dsl import karel_ast as A
from demo2program_tpu_torch.dsl import vizdoom_ast as D
from demo2program_tpu_torch.dsl.vizdoom_defs import (
    ACTION_LIST, ITEMS_IN_INTEREST, MERGE_DISTANCE_VOCAB,
    MERGE_HORIZONTAL_VOCAB, MONSTER_LIST)

_ACTIONS = set(ACTION_LIST)
_ACTORS = set(MONSTER_LIST) | set(ITEMS_IN_INTEREST)
_DISTANCES = set(MERGE_DISTANCE_VOCAB)
_HORIZONTALS = set(MERGE_HORIZONTAL_VOCAB)
# the runtime parser registers repeat counts R=0..19
# (`vizdoom_env/dsl/dsl_parse.py:283-287`)
_MIN_INT, _MAX_INT = 0, 19


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
            raise _SyntaxError("trailing tokens")
        return A.Program(body)

    def parse_stmt_seq(self, closing):
        node = self.parse_one_stmt()
        while self.peek() is not None and self.peek() != closing:
            node = A.Seq(node, self.parse_one_stmt())
        return node

    def parse_one_stmt(self):
        t = self.peek()
        if t in _ACTIONS:
            self.eat()
            return D.DoomAction(t)
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
        raise _SyntaxError(f"unexpected token {t!r}")

    def parse_cond(self):
        if self.peek() == "not":
            self.eat()
            self.eat("c(")
            inner = self.parse_cond()
            self.eat("c)")
            return A.Not(inner)
        return self.parse_percept()

    def parse_percept(self):
        t = self.eat()
        if t == "EXIST":
            actor = self.parse_actor()
            self.eat("IN")
            dist = self.eat()
            if dist not in _DISTANCES:
                raise _SyntaxError(f"bad distance {dist!r}")
            horz = self.eat()
            if horz not in _HORIZONTALS:
                raise _SyntaxError(f"bad horizontal {horz!r}")
            return D.DoomPercept("exist", actor, dist, horz)
        if t == "INTARGET":
            return D.DoomPercept("intarget", self.parse_actor())
        if t == "ISTHERE":
            return D.DoomPercept("isthere", self.parse_actor())
        raise _SyntaxError(f"expected percept, got {t!r}")

    def parse_actor(self):
        t = self.eat()
        if t not in _ACTORS:
            raise _SyntaxError(f"bad actor {t!r}")
        return t

    def parse_cste(self):
        t = self.eat()
        if not t.startswith("R="):
            raise _SyntaxError(f"expected R=<n>, got {t!r}")
        try:
            value = int(t[2:])
        except ValueError:
            raise _SyntaxError(f"bad integer {t!r}")
        if not (_MIN_INT <= value <= _MAX_INT):
            raise _SyntaxError(f"integer out of range {t!r}")
        return value


def parse(program):
    tokens = program.split() if isinstance(program, str) else list(program)
    try:
        return _Parser(tokens).parse_program(), True
    except _SyntaxError:
        return None, False
