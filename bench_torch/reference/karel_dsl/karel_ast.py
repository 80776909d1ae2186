"""AST node types for the Karel DSL.

The benchmark's copy of demo2program_tpu_torch/dsl/karel_ast.py, frozen
with the yardstick: the plain reference scores programs with it, so a
later change to the program's DSL code cannot move the reference.

Grammar (reference `karel_env/dsl/dsl_prob.py:112-285`):

    prog  := DEF run m( stmt m)
    stmt  := while | repeat | stmt_stmt | action | if | ifelse
    while := WHILE c( cond c) w( stmt w)
    repeat:= REPEAT R=n r( stmt r)
    if    := IF c( cond c) i( stmt i)
    ifelse:= IFELSE c( cond c) i( stmt i) ELSE e( stmt e)
    cond  := percept | not c( percept c)
    action:= move | turnRight | turnLeft | pickMarker | putMarker

Statement sequences associate LEFT — ``a b c`` parses as ``((a b) c)`` —
matching the reference's eager shift-reduce order
(`karel_env/dsl/dsl_parse.py:250-263`); this matters because the execution
call-budget accounting differs between associativity choices.
"""

from dataclasses import dataclass
from typing import Tuple, Union


@dataclass(frozen=True)
class Action:
    token: str  # one of ACTION_TOKENS


@dataclass(frozen=True)
class Percept:
    token: str  # one of PERCEPT_TOKENS


@dataclass(frozen=True)
class Not:
    cond: "Cond"


Cond = Union[Percept, Not]


@dataclass(frozen=True)
class Seq:  # stmt_stmt
    first: "Stmt"
    second: "Stmt"


@dataclass(frozen=True)
class If:
    cond: Cond
    body: "Stmt"


@dataclass(frozen=True)
class IfElse:
    cond: Cond
    body: "Stmt"
    else_body: "Stmt"


@dataclass(frozen=True)
class While:
    cond: Cond
    body: "Stmt"


@dataclass(frozen=True)
class Repeat:
    count: int  # 0..19
    body: "Stmt"


Stmt = Union[Action, Seq, If, IfElse, While, Repeat]


@dataclass(frozen=True)
class Program:
    body: Stmt


def to_tokens(node) -> Tuple[str, ...]:
    """Serialize an AST back to the surface token sequence."""
    if isinstance(node, Program):
        return ("DEF", "run", "m(") + to_tokens(node.body) + ("m)",)
    if isinstance(node, Action):
        return (node.token,)
    if isinstance(node, Percept):
        return (node.token,)
    if isinstance(node, Not):
        return ("not", "c(") + to_tokens(node.cond) + ("c)",)
    if isinstance(node, Seq):
        return to_tokens(node.first) + to_tokens(node.second)
    if isinstance(node, If):
        return (("IF", "c(") + to_tokens(node.cond) + ("c)", "i(")
                + to_tokens(node.body) + ("i)",))
    if isinstance(node, IfElse):
        return (("IFELSE", "c(") + to_tokens(node.cond) + ("c)", "i(")
                + to_tokens(node.body) + ("i)", "ELSE", "e(")
                + to_tokens(node.else_body) + ("e)",))
    if isinstance(node, While):
        return (("WHILE", "c(") + to_tokens(node.cond) + ("c)", "w(")
                + to_tokens(node.body) + ("w)",))
    if isinstance(node, Repeat):
        return (("REPEAT", f"R={node.count}", "r(")
                + to_tokens(node.body) + ("r)",))
    raise TypeError(f"unknown AST node: {node!r}")
