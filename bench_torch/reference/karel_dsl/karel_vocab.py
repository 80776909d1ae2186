"""Karel DSL token vocabulary.

The benchmark's copy of demo2program_tpu_torch/dsl/karel_vocab.py, frozen
with the yardstick: the plain reference scores programs with it, so a
later change to the program's DSL code cannot move the reference.

Parity target: the reference's PLY-derived vocab construction
(`karel_env/dsl/dsl_base.py:49-60` iterating the token list declared at
`karel_env/dsl/dsl_prob.py:13-28`). The integer ids below reproduce that
ordering exactly — datasets and checkpoints are interchangeable only if this
mapping matches:

    0 DEF   1 run   2 m(   3 m)
    4 move  5 turnRight  6 turnLeft  7 pickMarker  8 putMarker
    9 r(   10 r)
   11..30 R=0 .. R=19
   31 REPEAT  32 c(  33 c)  34 i(  35 i)  36 e(  37 e)
   38 IF  39 IFELSE  40 ELSE
   41 frontIsClear  42 leftIsClear  43 rightIsClear
   44 markersPresent  45 noMarkersPresent
   46 not  47 w(  48 w)  49 WHILE
"""

MIN_INT = 0
MAX_INT = 19
INT_PREFIX = "R="

ACTION_TOKENS = ["move", "turnRight", "turnLeft", "pickMarker", "putMarker"]
# order matters: perception index used by the interpreter/VM and the `per`
# vectors in datasets (reference `karel_env/karel.py:122-126`)
PERCEPT_TOKENS = [
    "frontIsClear", "leftIsClear", "rightIsClear",
    "markersPresent", "noMarkersPresent",
]

# DSL action token order -> environment action id
# (reference `karel_env/dsl/dsl_prob.py:272-276`: env order is
#  [move, turnLeft, turnRight, pickMarker, putMarker])
ACTION_TOKEN_TO_ENV = {
    "move": 0, "turnLeft": 1, "turnRight": 2,
    "pickMarker": 3, "putMarker": 4,
}
ENV_ACTION_TO_TOKEN = {v: k for k, v in ACTION_TOKEN_TO_ENV.items()}


def _build_int2token():
    toks = ["DEF", "run", "m(", "m)"]
    toks += ACTION_TOKENS
    toks += ["r(", "r)"]
    toks += [f"{INT_PREFIX}{i}" for i in range(MIN_INT, MAX_INT + 1)]
    toks += ["REPEAT", "c(", "c)", "i(", "i)", "e(", "e)",
             "IF", "IFELSE", "ELSE"]
    toks += PERCEPT_TOKENS
    toks += ["not", "w(", "w)", "WHILE"]
    return toks


class KarelVocab:
    """token <-> int codec, api parity with the reference DSL object
    (`str2intseq`/`intseq2str`, `karel_env/dsl/dsl_base.py:62-69`)."""

    def __init__(self):
        self.int2token = _build_int2token()
        self.token2int = {t: i for i, t in enumerate(self.int2token)}
        assert len(self.int2token) == 50
        self.num_program_tokens = len(self.int2token)
        self.action_functions = list(ACTION_TOKENS)
        self.num_action_tokens = len(ACTION_TOKENS)
        self.end_token = self.token2int["m)"]

    def str2intseq(self, code):
        return [self.token2int[t] for t in code.split()]

    # alias kept for reference api parity (`dsl_base.py:65-66`)
    code2intseq = str2intseq

    def intseq2str(self, intseq):
        return " ".join(self.int2token[int(i)] for i in intseq)
