"""ViZDoom DSL vocabulary per (perception_type, level).

The port's own copy of demo2program_tpu/dsl/vizdoom_vocab.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

Parity target: `vizdoom_env/dsl/vocab.py` — four vocab variants:
  level='simple'                -> SIMPLE tokens (no REPEAT/ISTHERE), 7 actions
  perception_type='simple'      -> INTARGET+ISTHERE percepts, 11 actions
  perception_type='more_simple' -> ISTHERE only, 11 actions
  otherwise (basic/'clear')     -> full grammar + distance/horizontal tokens

int ids = program tokens ++ actions ++ distance ++ horizontal ++ monsters
++ items (`vocab.py:56-58`), with the deterministic predicate-table ordering
from vizdoom_defs (see its docstring re py2 dict-order nondeterminism).
"""

from demo2program_tpu_torch.dsl.vizdoom_defs import (
    ACTION_LIST, CLEAR_DISTANCE_DICT, CLEAR_HORIZONTAL_DICT, DISTANCE_DICT,
    HORIZONTAL_DICT, ITEMS_IN_INTEREST, MONSTER_LIST)

SIMPLE_ACTION_LIST = ["MOVE_FORWARD", "MOVE_BACKWARD", "MOVE_LEFT",
                      "MOVE_RIGHT", "TURN_LEFT", "TURN_RIGHT", "ATTACK"]
SIMPLE_PROGRAM_TOKENS = ["DEF", "run", "m(", "m)", "WHILE", "c(", "c)",
                         "w(", "w)", "IF", "i(", "i)", "IFELSE", "ELSE",
                         "e(", "e)", "not", "EXIST", "IN", "INTARGET"]
PROGRAM_TOKENS = ["DEF", "run", "m(", "m)", "WHILE", "c(", "c)", "w(", "w)",
                  "REPEAT", "r(", "r)", "R=2", "R=3", "R=4", "R=5", "R=6",
                  "IF", "i(", "i)", "IFELSE", "ELSE", "e(", "e)", "not",
                  "EXIST", "IN", "INTARGET", "ISTHERE"]

_MID_ACTION_LIST = ["MOVE_FORWARD", "MOVE_BACKWARD", "MOVE_LEFT",
                    "MOVE_RIGHT", "TURN_LEFT", "TURN_RIGHT", "ATTACK",
                    "SELECT_WEAPON1", "SELECT_WEAPON3", "SELECT_WEAPON4",
                    "SELECT_WEAPON5"]
_MID_PROGRAM_TOKENS = ["DEF", "run", "m(", "m)", "WHILE", "c(", "c)",
                       "w(", "w)", "REPEAT", "r(", "r)", "R=2", "R=3",
                       "R=4", "R=5", "R=6", "IF", "i(", "i)",
                       "IFELSE", "ELSE", "e(", "e)", "not"]


class VizDoomDSLVocab:
    def __init__(self, perception_type="clear", level="not_simple"):
        self.perception_type = perception_type
        self.level = level
        if perception_type == "clear":
            distance_vocab = list(CLEAR_DISTANCE_DICT)
            horizontal_vocab = list(CLEAR_HORIZONTAL_DICT)
        elif perception_type in ("simple", "more_simple"):
            distance_vocab = []
            horizontal_vocab = []
        else:
            distance_vocab = list(DISTANCE_DICT)
            horizontal_vocab = list(HORIZONTAL_DICT)

        if level == "simple":
            action_list = SIMPLE_ACTION_LIST
            program_tokens = SIMPLE_PROGRAM_TOKENS
        elif perception_type == "simple":
            action_list = _MID_ACTION_LIST
            program_tokens = _MID_PROGRAM_TOKENS + ["INTARGET", "ISTHERE"]
        elif perception_type == "more_simple":
            action_list = _MID_ACTION_LIST
            program_tokens = _MID_PROGRAM_TOKENS + ["ISTHERE"]
        else:
            action_list = ACTION_LIST
            program_tokens = PROGRAM_TOKENS

        self.int2token = (program_tokens + action_list + distance_vocab
                          + horizontal_vocab + MONSTER_LIST
                          + ITEMS_IN_INTEREST)
        self.token2int = {v: i for i, v in enumerate(self.int2token)}
        self.action_int2token = list(action_list)
        self.action_token2int = {v: i for i, v in
                                 enumerate(self.action_int2token)}
        self.action_functions = list(action_list)
        self.num_action_tokens = len(action_list)
        self.num_program_tokens = len(self.int2token)
        self.end_token = self.token2int["m)"]

    def str2intseq(self, string):
        return [self.token2int[t] for t in string.split()]

    code2intseq = str2intseq

    def strlist2intseq(self, strlist):
        return [self.token2int[t] for t in strlist]

    def intseq2str(self, intseq):
        return " ".join(self.int2token[int(i)] for i in intseq)

    def token_dim(self):
        return len(self.int2token)

    def action_str2intseq(self, string):
        return [self.action_token2int[t] for t in string.split()]

    def action_intseq2str(self, intseq):
        return " ".join(self.action_int2token[int(i)] for i in intseq)

    def action_token_dim(self):
        return len(self.action_int2token)

    def action_strlist2intseq(self, strlist):
        return [self.action_token2int[t] for t in strlist]
