"""Exact-semantics host interpreter for the Karel DSL.

The benchmark's copy of demo2program_tpu_torch/dsl/karel_interp.py, frozen
with the yardstick: the plain reference scores programs with it, so a
later change to the program's DSL code cannot move the reference.

Parity target: the reference's closure-based fast interpreter
`karel_env/dsl/dsl_parse.py` — including its *call-budget* accounting, which
determines when long-running programs are declared failures (execution
accuracy depends on it). The budget rules, transcribed from the reference:

  * every closure checks ``n > MAX_FUNC_CALL`` at entry and fails (returns
    success=False) if exceeded; MAX_FUNC_CALL = 100 (`dsl_parse.py:22`)
  * prog calls its stmt with ``n+1`` (`dsl_parse.py:25-31`)
  * the generic stmt wrapper calls its inner node with ``n+1``
    (`dsl_parse.py:35-47`)
  * stmt_stmt calls the first stmt with ``n+1``, re-checks the budget, then
    calls the second stmt with the *current* n (`dsl_parse.py:50-59`)
  * if/ifelse call their cond with ``n+1`` and the taken branch with n
    (`dsl_parse.py:63-86`)
  * while calls cond and body with the current n — no increment of its own;
    loop progress is bounded because the body is a stmt wrapper (+1/iter)
    (`dsl_parse.py:89-103`)
  * repeat increments n once at entry, body iterations add via the wrapper
    (`dsl_parse.py:106-118`)
  * cond nodes and action nodes never increment n; actions catch environment
    exceptions and convert them into success=False (`dsl_parse.py:121-239`)

The on-device VM (ops/vm.py) is property-tested against this interpreter.
"""

from bench_torch.reference.karel_dsl import karel_ast as A
from bench_torch.reference.karel_dsl import karel_parser
from bench_torch.reference.karel_dsl.karel_vocab import ACTION_TOKEN_TO_ENV

MAX_FUNC_CALL = 100


def _exec_stmt_wrapper(node, world, n):
    """The 'stmt' wrapper rule (`dsl_parse.py:35-47`)."""
    if n > MAX_FUNC_CALL:
        return n, False
    return _exec_inner(node, world, n + 1)


def _exec_inner(node, world, n):
    if n > MAX_FUNC_CALL:
        return n, False

    if isinstance(node, A.Action):
        try:
            world.state_transition(ACTION_TOKEN_TO_ENV[node.token])
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
    """cond evaluation; returns (n, success, value). Never increments n
    (`dsl_parse.py:121-184`)."""
    if n > MAX_FUNC_CALL:
        return n, False, False
    if isinstance(node, A.Not):
        n, s, c = _eval_cond(node.cond, world, n)
        return n, s, (not c) if s else False
    if isinstance(node, A.Percept):
        t = node.token
        if t == "frontIsClear":
            return n, True, world.front_is_clear()
        if t == "leftIsClear":
            return n, True, world.left_is_clear()
        if t == "rightIsClear":
            return n, True, world.right_is_clear()
        if t == "markersPresent":
            return n, True, world.marker_present()
        if t == "noMarkersPresent":
            return n, True, world.no_marker_present()
    raise TypeError(f"unknown cond node: {node!r}")


def execute(ast, world, n=0):
    """Execute a parsed program against a KarelWorld.

    Mirrors the contract of the reference's compiled closure
    ``exe(karel_world, 0) -> (world, n, success)`` (`dsl_parse.py:25-31`):
    the world is mutated in place (history accumulates in world.s_h/a_h)
    and (n, success) is returned.
    """
    if not isinstance(ast, A.Program):
        raise TypeError("execute() expects a Program node")
    if n > MAX_FUNC_CALL:
        return n, False
    return _exec_stmt_wrapper(ast.body, world, n + 1)


def run_string(world, code):
    """Parse + clear history + execute; mirrors `dsl_base.KarelDSLBase.run`
    combined with dsl_parse semantics. Returns (ok_parse, n, success)."""
    ast, ok = karel_parser.parse(code)
    if not ok:
        return False, 0, False
    world.clear_history()
    n, success = execute(ast, world)
    return True, n, success
