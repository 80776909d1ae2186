"""Weighted CFG sampler for random Karel programs.

The port's own copy of demo2program_tpu/dsl/karel_sampler.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: `karel_env/dsl/dsl_prob.py:290-317` (`random_tokens`) with the
production probabilities declared inline in that file:

  stmt            : while repeat stmt_stmt action if ifelse
                    p = [0.1, 0.02, 0.7, 0.16, 0.01, 0.01]   (`:121`)
  cond            : percept | not c( percept c)   p=[0.9, 0.1] (`:215`)
  cond_without_not: frontIsClear leftIsClear rightIsClear markersPresent
                    noMarkersPresent              p=[0.7,0.1,0.1,0.05,0.05]
  action          : move turnRight turnLeft pickMarker putMarker
                    p=[0.7, 0.1, 0.1, 0.05, 0.05] (`:261`)
  cste            : R=<uniform 0..19>             (`:97-100`)

Depth bookkeeping matches the reference: every grammar descent increments
``depth``; descents into if/ifelse/repeat/while additionally increment
``nesting_depth``; when expanding a `stmt` with depth/nesting beyond the
limits, an `action` is forced (`dsl_prob.py:291-293`).

The sampled *distribution* matches the reference; the RNG stream does not
(the reference threads numpy RandomState through PLY grammar tables).
"""

import numpy as np

from demo2program_tpu_torch.dsl.karel_vocab import (
    ACTION_TOKENS, PERCEPT_TOKENS, MIN_INT, MAX_INT, INT_PREFIX,
)

_STMT_KINDS = ["while", "repeat", "stmt_stmt", "action", "if", "ifelse"]
_PROB_STMT = [0.1, 0.02, 0.7, 0.16, 0.01, 0.01]
_PROB_COND = [0.9, 0.1]
_PROB_PERCEPT = [0.7, 0.1, 0.1, 0.05, 0.05]
_PROB_ACTION = [0.7, 0.1, 0.1, 0.05, 0.05]
_NESTING_KINDS = {"while", "repeat", "if", "ifelse"}


class KarelProgramSampler:
    def __init__(self, seed=None):
        self.rng = np.random.RandomState(seed)

    def random_code(self, max_depth=6, max_nesting_depth=4):
        return " ".join(self.random_tokens(
            max_depth=max_depth, max_nesting_depth=max_nesting_depth))

    def random_tokens(self, max_depth=6, max_nesting_depth=4):
        # prog : DEF RUN M_LBRACE stmt M_RBRACE; the stmt descent is depth 1
        return (["DEF", "run", "m("]
                + self._stmt(1, max_depth, 1, max_nesting_depth)
                + ["m)"])

    def _choice(self, options, probs):
        return options[self.rng.choice(len(options), p=probs)]

    def _stmt(self, depth, max_depth, nesting, max_nesting):
        if nesting > max_nesting or depth > max_depth:
            kind = "action"
        else:
            kind = self._choice(_STMT_KINDS, _PROB_STMT)

        if kind == "action":
            return [self._choice(ACTION_TOKENS, _PROB_ACTION)]
        if kind == "stmt_stmt":
            # stmt -> stmt_stmt (depth+1) -> stmt stmt (depth+2): the two
            # children sit two grammar descents below the parent stmt
            # (`dsl_prob.py:299-306`)
            return (self._stmt(depth + 2, max_depth, nesting, max_nesting)
                    + self._stmt(depth + 2, max_depth, nesting, max_nesting))
        if kind == "while":
            return (["WHILE", "c("]
                    + self._cond(depth + 2, max_depth)
                    + ["c)", "w("]
                    + self._stmt(depth + 2, max_depth,
                                 nesting + 1, max_nesting)
                    + ["w)"])
        if kind == "repeat":
            return (["REPEAT", self._cste()]
                    + ["r("]
                    + self._stmt(depth + 2, max_depth,
                                 nesting + 1, max_nesting)
                    + ["r)"])
        if kind == "if":
            return (["IF", "c("]
                    + self._cond(depth + 2, max_depth)
                    + ["c)", "i("]
                    + self._stmt(depth + 2, max_depth,
                                 nesting + 1, max_nesting)
                    + ["i)"])
        if kind == "ifelse":
            return (["IFELSE", "c("]
                    + self._cond(depth + 2, max_depth)
                    + ["c)", "i("]
                    + self._stmt(depth + 2, max_depth,
                                 nesting + 1, max_nesting)
                    + ["i)", "ELSE", "e("]
                    + self._stmt(depth + 2, max_depth,
                                 nesting + 1, max_nesting)
                    + ["e)"])
        raise AssertionError(kind)

    def _cond(self, depth, max_depth):
        if self.rng.choice(2, p=_PROB_COND) == 1:
            return (["not", "c(", self._percept()] + ["c)"])
        return [self._percept()]

    def _percept(self):
        return self._choice(PERCEPT_TOKENS, _PROB_PERCEPT)

    def _cste(self):
        return f"{INT_PREFIX}{self.rng.randint(MIN_INT, MAX_INT + 1)}"
