"""ViZDoom DSL AST leaves.

The port's own copy of demo2program_tpu/dsl/vizdoom_ast.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Control-flow nodes (Program/Seq/If/IfElse/While/Repeat/Not) are shared with
the Karel DSL (dsl/karel_ast.py); only the leaves differ:

    action  := one of the 12 game macros (`vizdoom_env/dsl/dsl_parse.py:5-8`)
    percept := EXIST actor IN distance horizontal
             | INTARGET actor | ISTHERE actor          (`:176-200`)
"""

from dataclasses import dataclass
from typing import Optional

from demo2program_tpu_torch.dsl.karel_ast import (  # noqa: F401 (re-exported)
    IfElse, If, Not, Program, Repeat, Seq, While)
from demo2program_tpu_torch.dsl import karel_ast as A


@dataclass(frozen=True)
class DoomAction:
    token: str  # one of ACTION_LIST


@dataclass(frozen=True)
class DoomPercept:
    kind: str                     # 'exist' | 'intarget' | 'isthere'
    actor: str                    # monster or item name
    distance: Optional[str] = None
    horizontal: Optional[str] = None


def to_tokens(node):
    if isinstance(node, Program):
        return ("DEF", "run", "m(") + to_tokens(node.body) + ("m)",)
    if isinstance(node, DoomAction):
        return (node.token,)
    if isinstance(node, DoomPercept):
        if node.kind == "exist":
            return ("EXIST", node.actor, "IN", node.distance,
                    node.horizontal)
        if node.kind == "intarget":
            return ("INTARGET", node.actor)
        if node.kind == "isthere":
            return ("ISTHERE", node.actor)
        raise ValueError(node.kind)
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
