"""ViZDoom DSL interpreter with exact reference budget semantics.

The port's own copy of demo2program_tpu/dsl/vizdoom_interp.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: `vizdoom_env/dsl/dsl_parse.py` — the control-flow call-budget
accounting is identical to the Karel interpreter (see dsl/karel_interp.py for
the full transcription); leaves differ:

  * actions call world.state_transition(action_string); exceptions become
    success=False (`:269-276`)
  * percepts call world.exist_actor_in_distance_horizontal / in_target /
    is_there (`:176-200`)

The world is duck-typed (the real engine wrapper in envs/vizdoom.py, or a
fake in tests).
"""

from demo2program_tpu_torch.dsl import karel_ast as A
from demo2program_tpu_torch.dsl import vizdoom_ast as D
from demo2program_tpu_torch.dsl import vizdoom_parser

MAX_FUNC_CALL = 100


def _exec_stmt_wrapper(node, world, n):
    if n > MAX_FUNC_CALL:
        return n, False
    return _exec_inner(node, world, n + 1)


def _exec_inner(node, world, n):
    if n > MAX_FUNC_CALL:
        return n, False

    if isinstance(node, D.DoomAction):
        try:
            world.state_transition(node.token)
        except Exception:
            return n, False
        return n, True

    if isinstance(node, A.Seq):
        n, s = _exec_stmt_wrapper(node.first, world, n + 1)
        if not s:
            return n, s
        if n > MAX_FUNC_CALL:
            return n, False
        return _exec_stmt_wrapper(node.second, world, n)

    if isinstance(node, A.If):
        n, s, c = _eval_cond(node.cond, world, n + 1)
        if not s:
            return n, s
        if c:
            return _exec_stmt_wrapper(node.body, world, n)
        return n, s

    if isinstance(node, A.IfElse):
        n, s, c = _eval_cond(node.cond, world, n + 1)
        if not s:
            return n, s
        if c:
            return _exec_stmt_wrapper(node.body, world, n)
        return _exec_stmt_wrapper(node.else_body, world, n)

    if isinstance(node, A.While):
        n, s, c = _eval_cond(node.cond, world, n)
        if not s:
            return n, s
        while c:
            n, s = _exec_stmt_wrapper(node.body, world, n)
            if not s:
                return n, s
            n, s, c = _eval_cond(node.cond, world, n)
            if not s:
                return n, s
        return n, s

    if isinstance(node, A.Repeat):
        n += 1
        s = True
        for _ in range(node.count):
            n, s = _exec_stmt_wrapper(node.body, world, n)
            if not s:
                return n, s
        return n, s

    raise TypeError(f"unknown stmt node: {node!r}")


def _eval_cond(node, world, n):
    if n > MAX_FUNC_CALL:
        return n, False, False
    if isinstance(node, A.Not):
        n, s, c = _eval_cond(node.cond, world, n)
        return n, s, (not c) if s else False
    if isinstance(node, D.DoomPercept):
        if node.kind == "exist":
            return n, True, world.exist_actor_in_distance_horizontal(
                node.actor, node.distance, node.horizontal)
        if node.kind == "intarget":
            return n, True, world.in_target(node.actor)
        if node.kind == "isthere":
            return n, True, world.is_there(node.actor)
    raise TypeError(f"unknown cond node: {node!r}")


def execute(ast, world, n=0):
    """exe(world, 0) -> (n, success); world histories accumulate in place."""
    if not isinstance(ast, A.Program):
        raise TypeError("execute() expects a Program node")
    if n > MAX_FUNC_CALL:
        return n, False
    return _exec_stmt_wrapper(ast.body, world, n + 1)


def run_string(world, code):
    ast, ok = vizdoom_parser.parse(code)
    if not ok:
        return False, 0, False
    n, success = execute(ast, world)
    return True, n, success
