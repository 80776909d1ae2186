"""Per-token execution hit counts for DSL programs.

The port's copy of demo2program_tpu/tools/hit_analysis.py, on the port's
own DSL (dsl/karel_*, dsl/vizdoom_*): host-side, it touches no device.

Parity target: `vizdoom_env/dsl/dsl_hit_analysis.py` — an interpreter variant
that, besides executing the program, reports which program tokens were
actually exercised (e.g. a dead ELSE branch's tokens get zero hits). Works
for both domains since the control nodes are shared.

hit_count(code, domain) -> (exe, ok) where exe(world) runs the program and
returns (hits, n, success); `hits` is an int array over the program's token
positions counting how many times each token's node was executed.
"""

import numpy as np

from demo2program_tpu_torch.dsl import karel_ast as A
from demo2program_tpu_torch.dsl import vizdoom_ast as D
from demo2program_tpu_torch.dsl import karel_parser, vizdoom_parser
from demo2program_tpu_torch.dsl.karel_vocab import ACTION_TOKEN_TO_ENV

MAX_FUNC_CALL = 100


def _token_len(node, domain):
    to_tokens = D.to_tokens if domain == "vizdoom" else A.to_tokens
    return len(to_tokens(node))


class _Spans:
    """Assigns each AST node its (start, end) token span by mirroring the
    serialization layout."""

    def __init__(self, domain):
        self.domain = domain
        self.spans = {}

    def annotate(self, node, start):
        n = _token_len(node, self.domain)
        self.spans[id(node)] = (start, start + n)
        if isinstance(node, A.Program):
            self.annotate(node.body, start + 3)
        elif isinstance(node, A.Seq):
            self.annotate(node.first, start)
            self.annotate(node.second,
                          start + _token_len(node.first, self.domain))
        elif isinstance(node, A.If):
            c = start + 2
            self.annotate(node.cond, c)
            self.annotate(node.body,
                          c + _token_len(node.cond, self.domain) + 2)
        elif isinstance(node, A.IfElse):
            c = start + 2
            clen = _token_len(node.cond, self.domain)
            self.annotate(node.cond, c)
            body_start = c + clen + 2
            self.annotate(node.body, body_start)
            blen = _token_len(node.body, self.domain)
            self.annotate(node.else_body, body_start + blen + 3)
        elif isinstance(node, A.While):
            c = start + 2
            self.annotate(node.cond, c)
            self.annotate(node.body,
                          c + _token_len(node.cond, self.domain) + 2)
        elif isinstance(node, A.Repeat):
            self.annotate(node.body, start + 3)
        elif isinstance(node, A.Not):
            self.annotate(node.cond, start + 2)
        return self.spans


class _HitInterp:
    def __init__(self, ast, domain):
        self.domain = domain
        self.spans = _Spans(domain).annotate(ast, 0)
        self.n_tokens = _token_len(ast, domain)
        self.ast = ast

    def _hit(self, hits, node):
        s, e = self.spans[id(node)]
        hits[s] += 1        # structural head token of the node
        return hits

    def _act(self, node, world):
        if self.domain == "vizdoom":
            world.state_transition(node.token)
        else:
            world.state_transition(ACTION_TOKEN_TO_ENV[node.token])

    def _eval_percept(self, node, world):
        if self.domain == "vizdoom":
            if node.kind == "exist":
                return world.exist_actor_in_distance_horizontal(
                    node.actor, node.distance, node.horizontal)
            if node.kind == "intarget":
                return world.in_target(node.actor)
            return world.is_there(node.actor)
        t = node.token
        return {"frontIsClear": world.front_is_clear,
                "leftIsClear": world.left_is_clear,
                "rightIsClear": world.right_is_clear,
                "markersPresent": world.marker_present,
                "noMarkersPresent": world.no_marker_present}[t]()

    def run(self, world, n=0):
        hits = np.zeros(self.n_tokens, np.int64)
        if n > MAX_FUNC_CALL:
            return hits, n, False
        n, s = self._stmt(self.ast.body, world, n + 1, hits)
        return hits, n, s

    def _stmt(self, node, world, n, hits):
        if n > MAX_FUNC_CALL:
            return n, False
        return self._inner(node, world, n + 1, hits)

    def _inner(self, node, world, n, hits):
        if n > MAX_FUNC_CALL:
            return n, False
        is_action = isinstance(node, (A.Action, D.DoomAction))
        if is_action:
            self._hit(hits, node)
            try:
                self._act(node, world)
            except Exception:
                return n, False
            return n, True
        if isinstance(node, A.Seq):
            n, s = self._stmt(node.first, world, n + 1, hits)
            if not s:
                return n, s
            if n > MAX_FUNC_CALL:
                return n, False
            return self._stmt(node.second, world, n, hits)
        if isinstance(node, A.If):
            self._hit(hits, node)
            n, s, c = self._cond(node.cond, world, n + 1, hits)
            if not s:
                return n, s
            if c:
                return self._stmt(node.body, world, n, hits)
            return n, s
        if isinstance(node, A.IfElse):
            self._hit(hits, node)
            n, s, c = self._cond(node.cond, world, n + 1, hits)
            if not s:
                return n, s
            if c:
                return self._stmt(node.body, world, n, hits)
            return self._stmt(node.else_body, world, n, hits)
        if isinstance(node, A.While):
            self._hit(hits, node)
            n, s, c = self._cond(node.cond, world, n, hits)
            if not s:
                return n, s
            while c:
                n, s = self._stmt(node.body, world, n, hits)
                if not s:
                    return n, s
                n, s, c = self._cond(node.cond, world, n, hits)
                if not s:
                    return n, s
            return n, s
        if isinstance(node, A.Repeat):
            self._hit(hits, node)
            n += 1
            s = True
            for _ in range(node.count):
                n, s = self._stmt(node.body, world, n, hits)
                if not s:
                    return n, s
            return n, s
        raise TypeError(node)

    def _cond(self, node, world, n, hits):
        if n > MAX_FUNC_CALL:
            return n, False, False
        if isinstance(node, A.Not):
            self._hit(hits, node)
            n, s, c = self._cond(node.cond, world, n, hits)
            return n, s, (not c) if s else False
        self._hit(hits, node)
        return n, True, self._eval_percept(node, world)


def hit_count(code, domain="vizdoom"):
    """-> (exe, ok); exe(world, n=0) -> (hits, n, success)."""
    parser = vizdoom_parser if domain == "vizdoom" else karel_parser
    ast, ok = parser.parse(code)
    if not ok:
        return None, False
    interp = _HitInterp(ast, domain)
    return interp.run, True
