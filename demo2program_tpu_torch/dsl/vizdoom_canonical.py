"""Canonical-form expansion for ViZDoom programs.

The port's own copy of demo2program_tpu/dsl/vizdoom_canonical.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: `vizdoom_env/dsl/dsl_enum_program.py` — same rewriting rules
as the Karel canonicalizer but with MAX_WHILE = 1000 (`:67`) and percept
leaves expanding to method-name token lists (`:176-200`):

    EXIST a IN d h -> ['exist_actor_in_distance_horizontal', a, d, h]
    INTARGET a     -> ['in_target', a]
    ISTHERE a      -> ['is_there', a]
"""

from demo2program_tpu_torch.dsl import karel_ast as A
from demo2program_tpu_torch.dsl import vizdoom_ast as D
from demo2program_tpu_torch.dsl import vizdoom_parser
from demo2program_tpu_torch.dsl.karel_canonical import (
    CanonicalTooLarge, DEFAULT_MAX_SIZE)

MAX_WHILE = 1000


def _canon_cond(node):
    if isinstance(node, D.DoomPercept):
        if node.kind == "exist":
            return ["exist_actor_in_distance_horizontal", node.actor,
                    node.distance, node.horizontal]
        if node.kind == "intarget":
            return ["in_target", node.actor]
        if node.kind == "isthere":
            return ["is_there", node.actor]
        raise ValueError(node.kind)
    if isinstance(node, A.Not):
        inner = _canon_cond(node.cond)
        if inner[0] == "not":
            return inner[1:]
        return ["not"] + inner
    raise TypeError(f"unknown cond node: {node!r}")


def _canon_stmt(node, budget):
    def charge(k):
        budget[0] -= k
        if budget[0] < 0:
            raise CanonicalTooLarge()

    if isinstance(node, D.DoomAction):
        charge(1)
        return [node.token]
    if isinstance(node, A.Seq):
        out = _canon_stmt(node.first, budget)
        out.extend(_canon_stmt(node.second, budget))
        return out
    if isinstance(node, A.If):
        cond = _canon_cond(node.cond)
        body = _canon_stmt(node.body, budget)
        charge(1 + len(cond))
        return ["if"] + cond + body
    if isinstance(node, A.IfElse):
        body1 = _canon_stmt(node.body, budget)
        body2 = _canon_stmt(node.else_body, budget)
        if body1 == body2:
            return body1
        cond = _canon_cond(node.cond)
        if cond[0] == "not":
            else_cond = ["if"] + cond[1:]
        else:
            else_cond = ["if", "not"] + cond
        charge(1 + len(cond) + len(else_cond))
        return ["if"] + cond + body1 + else_cond + body2
    if isinstance(node, A.While):
        cond = _canon_cond(node.cond)
        body = _canon_stmt(node.body, budget)
        charge((1 + len(cond) + len(body)) * MAX_WHILE)
        block = ["if"] + cond + body
        out = []
        for _ in range(MAX_WHILE):
            out.extend(block)
        return out
    if isinstance(node, A.Repeat):
        body = _canon_stmt(node.body, budget)
        charge(len(body) * node.count)
        out = []
        for _ in range(node.count):
            out.extend(body)
        return out
    raise TypeError(f"unknown stmt node: {node!r}")


def canonicalize(ast, max_size=DEFAULT_MAX_SIZE):
    if isinstance(ast, A.Program):
        ast = ast.body
    return _canon_stmt(ast, [max_size])


def parse(program_str, max_size=DEFAULT_MAX_SIZE):
    ast, ok = vizdoom_parser.parse(program_str)
    if not ok:
        return None, False
    try:
        return canonicalize(ast, max_size=max_size), True
    except CanonicalTooLarge:
        return None, False


def programs_equal(code_a, code_b, max_size=DEFAULT_MAX_SIZE):
    if code_a.split() == code_b.split():
        return True
    ca, ok_a = parse(code_a, max_size=max_size)
    cb, ok_b = parse(code_b, max_size=max_size)
    if not (ok_a and ok_b):
        return False
    return ca == cb
