"""Canonical-form expansion for Karel programs.

The benchmark's copy of demo2program_tpu_torch/dsl/karel_canonical.py, frozen
with the yardstick: the plain reference scores programs with it, so a
later change to the program's DSL code cannot move the reference.

Parity target: `karel_env/dsl/dsl_enum_program.py` — used for the *program
accuracy* metric: two programs are semantically equal iff their canonical
token expansions are identical lists (`model_full.py:713-728`).

Expansion rules (reference lines noted):
  * while  -> the `if cond body` block repeated MAX_WHILE=100 times
    (`dsl_enum_program.py:82-93`)
  * repeat -> body repeated `count` times (`:96-105`)
  * ifelse -> `if cond body if (not)cond else_body`; if both branches expand
    identically the conditional disappears (`:64-79`)
  * noMarkersPresent -> `not markersPresent` (`:159-163`)
  * double negation eliminated (`:117-128`)
  * actions expand to themselves; the DEF run m( m) wrapper is dropped
    (`:25-29`)

Nested whiles blow up the expansion 100x per level; the reference builds the
full Python list regardless. We bound the work with ``max_size`` and raise
``CanonicalTooLarge`` beyond it (the comparison helper then falls back to
exact token equality) — a deliberate, documented divergence that only affects
pathological predictions the reference itself could not score in reasonable
time/memory.
"""

import functools
import hashlib

from bench_torch.reference.karel_dsl import karel_ast as A
from bench_torch.reference.karel_dsl import karel_parser

MAX_WHILE = 100
DEFAULT_MAX_SIZE = 20_000_000


class CanonicalTooLarge(Exception):
    pass


def _canon_cond(node):
    """Returns the canonical token list of a condition."""
    if isinstance(node, A.Percept):
        if node.token == "noMarkersPresent":
            return ["not", "markersPresent"]
        return [node.token]
    if isinstance(node, A.Not):
        inner = _canon_cond(node.cond)
        if inner[0] == "not":
            return inner[1:]
        return ["not"] + inner
    raise TypeError(f"unknown cond node: {node!r}")


def _canon_stmt(node, max_size, budget):
    """Returns canonical token list; `budget` is a single-element list holding
    the remaining token allowance (shared across the recursion)."""
    def charge(k):
        budget[0] -= k
        if budget[0] < 0:
            raise CanonicalTooLarge()

    if isinstance(node, A.Action):
        charge(1)
        return [node.token]
    if isinstance(node, A.Seq):
        out = _canon_stmt(node.first, max_size, budget)
        out.extend(_canon_stmt(node.second, max_size, budget))
        return out
    if isinstance(node, A.If):
        cond = _canon_cond(node.cond)
        body = _canon_stmt(node.body, max_size, budget)
        charge(1 + len(cond))
        return ["if"] + cond + body
    if isinstance(node, A.IfElse):
        body1 = _canon_stmt(node.body, max_size, budget)
        body2 = _canon_stmt(node.else_body, max_size, budget)
        if body1 == body2:
            # both branches equivalent -> conditional vanishes
            # (`dsl_enum_program.py:68-71`)
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
        body = _canon_stmt(node.body, max_size, budget)
        unit = 1 + len(cond) + len(body)
        charge(unit * MAX_WHILE)
        block = ["if"] + cond + body
        out = []
        for _ in range(MAX_WHILE):
            out.extend(block)
        return out
    if isinstance(node, A.Repeat):
        body = _canon_stmt(node.body, max_size, budget)
        charge(len(body) * node.count)
        out = []
        for _ in range(node.count):
            out.extend(body)
        return out
    raise TypeError(f"unknown stmt node: {node!r}")


def canonicalize(ast, max_size=DEFAULT_MAX_SIZE):
    """Program AST -> canonical token list (may raise CanonicalTooLarge)."""
    if isinstance(ast, A.Program):
        ast = ast.body
    return _canon_stmt(ast, max_size, [max_size])


# how often the size cap forces programs_equal down to exact-token
# comparison
STATS = {"compares": 0, "cap_fallbacks": 0}


def parse(program_str, max_size=DEFAULT_MAX_SIZE):
    """API parity with `dsl_enum_program.parse(str) -> (canonical, ok)`."""
    ast, ok = karel_parser.parse(program_str)
    if not ok:
        return None, False
    try:
        return canonicalize(ast, max_size=max_size), True
    except CanonicalTooLarge:
        return None, False


@functools.lru_cache(maxsize=200_000)
def canonical_digest(program_str, max_size=DEFAULT_MAX_SIZE):
    """(blake2b-128 digest of the canonical form, status) — memoized per
    unique program string; status is 'ok' | 'parse' | 'cap'. Digest equality
    stands in for list equality (collision odds ~2^-64 at this scale), so
    the 100x-unrolled expansions are built ONCE per unique prediction
    instead of per comparison — the dominant host cost in eval (reference
    rebuilds them per batch element per fetch, `dsl_enum_program.py:209-222`
    via `model_full.py:713-728`)."""
    ast, ok = karel_parser.parse(program_str)
    if not ok:
        return None, "parse"
    try:
        c = canonicalize(ast, max_size=max_size)
    except CanonicalTooLarge:
        return None, "cap"
    h = hashlib.blake2b("\x00".join(c).encode(), digest_size=16).digest()
    return h, "ok"


def programs_equal(code_a, code_b, max_size=DEFAULT_MAX_SIZE):
    """Semantic equality via canonical forms, with a fallback to exact token
    equality when an expansion exceeds max_size (counted in STATS)."""
    STATS["compares"] += 1
    if code_a.split() == code_b.split():
        return True
    da, st_a = canonical_digest(" ".join(code_a.split()), max_size)
    db, st_b = canonical_digest(" ".join(code_b.split()), max_size)
    if "cap" in (st_a, st_b):
        STATS["cap_fallbacks"] += 1
    if not (st_a == "ok" and st_b == "ok"):
        return False
    return da == db
