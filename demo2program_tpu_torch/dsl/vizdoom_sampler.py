"""ViZDoom random program generators with percept balancing.

The port's own copy of demo2program_tpu/dsl/vizdoom_sampler.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: `vizdoom_env/dsl/random_code_generator.py` (standard) and
`random_code_generator_ifelse.py` (single-IFELSE dataset variant):

  * weighted template expansion with per-depth statement-count spans
    (`random_code_generator.py:5-8, 106-117`)
  * each percept slot is filled by sampling a percept token string with
    probability proportional to the SQUARED balance of its truth value
    across the k demo worlds (`:86-98`)
  * every completed sub-statement of kind action/if/ifelse/while/repeat is
    EXECUTED on all demo worlds as generation proceeds; any failure rejects
    the candidate (`:118-146`)

Worlds are duck-typed: they need get_perception_vector() plus whatever the
interpreter leaves call (envs/vizdoom.py or a fake in tests).
"""

import numpy as np

from demo2program_tpu_torch.dsl import vizdoom_interp, vizdoom_parser

STMT_LENGTH_RANGE = {"span0": (1, 3), "span1": (1, 2), "span2": (1, 2)}
STMT_LENGTH_RANGE_IFELSE = {"span0": (1, 2), "span1": (1, 2), "span2": (1, 2)}

RULES = {
    "prog": [("DEF run m( stmt0 m)", 1.0)],
    "action": [
        ("MOVE_FORWARD", 0.1), ("MOVE_BACKWARD", 0.1), ("MOVE_LEFT", 0.2),
        ("MOVE_RIGHT", 0.2), ("TURN_LEFT", 0.1), ("TURN_RIGHT", 0.1),
        ("ATTACK", 0.2)],
    "stmt0": [
        ("action_stmt1", 0.2), ("if_stmt1", 0.25), ("ifelse_stmt1", 0.24),
        ("while_stmt1", 0.3), ("repeat_stmt1", 0.01)],
    "stmt1": [
        ("action_stmt1", 0.2), ("if_stmt1", 0.25), ("ifelse_stmt1", 0.24),
        ("while_stmt1", 0.3), ("repeat_stmt1", 0.01)],
    "stmt2": [("action", 0.8), ("action action", 0.2)],
    "action_stmt1": [
        ("action", 0.85), ("action action", 0.1),
        ("action action action", 0.05)],
    "if_stmt1": [("IF c( cond c) i( stmt2 i)", 1.0)],
    "ifelse_stmt1": [
        ("IFELSE c( cond c) i( stmt2 i) ELSE e( stmt2 e)", 1.0)],
    "while_stmt1": [("WHILE c( cond c) w( stmt2 w)", 1.0)],
    "repeat_stmt1": [("REPEAT cste r( stmt2 r)", 1.0)],
    "if_stmt2": [("IF c( cond c) i( stmt1 i)", 1.0)],
    "ifelse_stmt2": [("IFELSE c( cond c) i( stmt1 i) ELSE e( stmt1 e)", 1.0)],
    "while_stmt2": [("WHILE c( cond c) w( stmt1 w)", 1.0)],
    "repeat_stmt2": [("REPEAT cste r( stmt1 r)", 1.0)],
    "cond": [("not c( percept c)", 0.2), ("percept", 0.8)],
    "cste": [("R=2", 0.4), ("R=3", 0.3), ("R=4", 0.3)],
}

RULES_IFELSE = {
    "prog": [("DEF run m( stmt0 m)", 1.0)],
    "action": [
        ("MOVE_FORWARD", 0.1), ("MOVE_BACKWARD", 0.1), ("MOVE_LEFT", 0.2),
        ("MOVE_RIGHT", 0.2), ("TURN_LEFT", 0.1), ("TURN_RIGHT", 0.1),
        ("ATTACK", 0.1), ("SELECT_WEAPON1", 0.025), ("SELECT_WEAPON3", 0.025),
        ("SELECT_WEAPON4", 0.025), ("SELECT_WEAPON5", 0.025)],
    "stmt0": [("ifelse_stmt1", 1.0)],
    "stmt2": [("action", 1.0)],
    "ifelse_stmt1": [
        ("IFELSE c( cond c) i( stmt2 i) ELSE e( stmt2 e)", 1.0)],
    "cond": [("not c( percept c)", 0.2), ("percept", 0.8)],
}

_EXECUTED_KINDS = ("action_stmt1", "if_stmt1", "ifelse_stmt1",
                   "while_stmt1", "repeat_stmt1")


class DoomProgramGenerator:
    def __init__(self, seed=123, rules=None, stmt_length_range=None):
        self.rng = np.random.RandomState(seed)
        self.rules = rules or RULES
        self.stmt_length_range = stmt_length_range or STMT_LENGTH_RANGE

    def get_percepts_value(self, world_list):
        return np.stack([w.get_perception_vector()
                         for w in world_list]).astype(float)

    def compute_percepts_prob(self, world_list):
        """p(percept) ∝ (n/2 - |n/2 - #true|)^2 — favours percepts whose
        truth value is balanced across the demo worlds
        (`random_code_generator.py:86-98`)."""
        values = self.get_percepts_value(world_list)
        n = float(len(world_list))
        s = values.sum(axis=0)
        diff = (n / 2.0 - np.abs(n / 2.0 - s)) ** 2
        if diff.sum() == 0:
            diff = diff + 1e-10
        return diff / diff.sum()

    def _expand(self, token, percepts, world_list, depth):
        candidates, probs = zip(*self.rules[token])
        probs = np.asarray(probs, dtype=float)
        idx = self.rng.choice(len(candidates), p=probs / probs.sum())
        expansion = []
        for t in candidates[idx].split():
            if t in ("stmt0", "stmt1", "stmt2"):
                lo, hi = self.stmt_length_range[f"span{depth}"]
                expansion.extend([t] * self.rng.choice(range(lo, hi)))
            else:
                expansion.append(t)
        codes = []
        for t in expansion:
            if t in self.rules:
                d = depth + 1 if t in ("stmt0", "stmt1", "stmt2") else depth
                sub, ok = self._expand(t, percepts, world_list, d)
                if not ok:
                    return [], False
                codes.extend(sub)
            elif t == "percept":
                p = self.compute_percepts_prob(world_list)
                codes.append(percepts[self.rng.choice(len(percepts), p=p)])
            else:
                codes.append(t)

        if token in _EXECUTED_KINDS:
            # validate the fresh statement on every demo world by running it.
            # The reference parses the BARE statement and calls its stmt
            # closure with n=0 (`random_code_generator.py:135-146`) — i.e.
            # the stmt-wrapper budget, without the prog-level increments.
            stmt = " ".join(codes)
            ast, ok = vizdoom_parser.parse(f"DEF run m( {stmt} m)")
            if not ok:
                raise RuntimeError("Compile failure should not happen")
            for world in world_list:
                _, success = vizdoom_interp._exec_stmt_wrapper(
                    ast.body, world, 0)
                if not success:
                    return [], False
        return codes, True

    def random_code(self, percepts, world_list):
        codes, success = self._expand("prog", percepts, world_list, depth=0)
        return " ".join(codes), success


class DoomProgramGeneratorIfElse(DoomProgramGenerator):
    """Emits exactly one IFELSE program
    (`random_code_generator_ifelse.py:27-40`)."""

    def __init__(self, seed=123):
        super().__init__(seed, rules=RULES_IFELSE,
                         stmt_length_range=STMT_LENGTH_RANGE_IFELSE)
