"""Prefix-syntax oracle for the Karel DSL as a table-driven pushdown
automaton.

Parity target: `karel_env/dsl/dsl_prob_syntax.py` + `dsl_syntax.py` — the
reference parses program *prefixes* with a PLY grammar and returns the legal
next tokens with the minimum number of tokens needed to complete the program
(candidate included), e.g. after 'DEF' the only candidate is ('run', 4)
(`dsl_prob_syntax.py:131-134`). Syntax-constrained decoding filters
candidates by `count <= max_program_len - len(prefix)`
(`models/seq2seq_helper.py:252-254`).

The reference implementation is host-side Python invoked through tf.py_func
on every decode step of every batch element; it also carries a latent
AttributeError on the INT paths (SURVEY.md quirk (d)). This re-design builds
an explicit pushdown: a stack of expected symbols, a (symbol x token)
legality table, replacement/push tables, and per-symbol minimum completion
counts. The SAME tables drive both the host oracle here and the on-device
constrained decoder (models/decoder.py via `torch_tables`), so the masks
used on the device are the ones tested against the grammar on the host.

The port's own copy of demo2program_tpu/dsl/karel_syntax.py (numpy only);
its `jnp_tables` is `torch_tables(device)` here.

Grammar note: nested `not c( ... c)` is allowed, matching the runtime parser
(karel_parser.py) which adjudicates syntax accuracy.
"""

import numpy as np

from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab

# -- stack symbols ------------------------------------------------------------
S_DEF, S_RUN, S_M_OPEN, S_C_OPEN, S_C_CLOSE, S_I_OPEN, S_E_OPEN, S_W_OPEN, \
    S_R_OPEN, S_ELSE, S_INT, S_COND, \
    S_REQ_M, S_OPT_M, S_REQ_I, S_OPT_I, S_REQ_E, S_OPT_E, \
    S_REQ_W, S_OPT_W, S_REQ_R, S_OPT_R = range(22)
NUM_SYMBOLS = 22
MAX_PUSH = 8
STACK_DEPTH = 64

# minimum tokens to satisfy each stack symbol
SYMBOL_MIN = np.ones(NUM_SYMBOLS, np.int32)
for _s in (S_REQ_M, S_REQ_I, S_REQ_E, S_REQ_W, S_REQ_R):
    SYMBOL_MIN[_s] = 2  # one 1-token stmt + the closing token

_REQ_TO_OPT = {S_REQ_M: S_OPT_M, S_REQ_I: S_OPT_I, S_REQ_E: S_OPT_E,
               S_REQ_W: S_OPT_W, S_REQ_R: S_OPT_R}
_OPT_CLOSER = {S_OPT_M: "m)", S_OPT_I: "i)", S_OPT_E: "e)",
               S_OPT_W: "w)", S_OPT_R: "r)"}
_TERMINAL_TOKEN = {S_DEF: "DEF", S_RUN: "run", S_M_OPEN: "m(",
                   S_C_OPEN: "c(", S_C_CLOSE: "c)", S_I_OPEN: "i(",
                   S_E_OPEN: "e(", S_W_OPEN: "w(", S_R_OPEN: "r(",
                   S_ELSE: "ELSE"}

# continuation pushed when a statement-starting token is consumed, listed
# bottom-to-top (the LAST element ends up on top of the stack)
_STMT_PUSH = {
    "WHILE": [S_REQ_W, S_W_OPEN, S_C_CLOSE, S_COND, S_C_OPEN],
    "REPEAT": [S_REQ_R, S_R_OPEN, S_INT],
    "IF": [S_REQ_I, S_I_OPEN, S_C_CLOSE, S_COND, S_C_OPEN],
    "IFELSE": [S_REQ_E, S_E_OPEN, S_ELSE,
               S_REQ_I, S_I_OPEN, S_C_CLOSE, S_COND, S_C_OPEN],
}
_NOT_PUSH = [S_C_CLOSE, S_COND, S_C_OPEN]

ILLEGAL = -2
POP = -1


def build_tables():
    """Returns dict of numpy tables:
      legal    (S, V)  bool
      repl     (S, V)  int8   symbol replacing the top (POP = pop it)
      push_seq (S, V, MAX_PUSH) int8
      push_len (S, V)  int8
      delta    (S, V)  int32  change of the stack's min-completion sum
    """
    vocab = KarelVocab()
    V = len(vocab.int2token)
    legal = np.zeros((NUM_SYMBOLS, V), bool)
    repl = np.full((NUM_SYMBOLS, V), ILLEGAL, np.int8)
    push_seq = np.full((NUM_SYMBOLS, V, MAX_PUSH), -1, np.int8)
    push_len = np.zeros((NUM_SYMBOLS, V), np.int8)

    t2i = vocab.token2int
    action_ids = [t2i[a] for a in
                  ["move", "turnRight", "turnLeft", "pickMarker",
                   "putMarker"]]
    percept_ids = [t2i[p] for p in
                   ["frontIsClear", "leftIsClear", "rightIsClear",
                    "markersPresent", "noMarkersPresent"]]
    int_ids = [t2i[f"R={i}"] for i in range(20)]

    def allow(sym, tok_id, replacement, pushes):
        legal[sym, tok_id] = True
        repl[sym, tok_id] = replacement
        push_len[sym, tok_id] = len(pushes)
        for j, p in enumerate(pushes):
            push_seq[sym, tok_id, j] = p

    # terminals
    for sym, tok in _TERMINAL_TOKEN.items():
        allow(sym, t2i[tok], POP, [])
    for tid in int_ids:
        allow(S_INT, tid, POP, [])

    # conditions
    for pid in percept_ids:
        allow(S_COND, pid, POP, [])
    allow(S_COND, t2i["not"], POP, _NOT_PUSH)

    # statement positions
    for req, opt in _REQ_TO_OPT.items():
        for tops, replacement in ((req, opt), (opt, opt)):
            for aid in action_ids:
                allow(tops, aid, replacement, [])
            for tok, pushes in _STMT_PUSH.items():
                allow(tops, t2i[tok], replacement, pushes)
        # closers pop the OPT symbol
        allow(opt, t2i[_OPT_CLOSER[opt]], POP, [])

    # min-completion delta per transition
    delta = np.zeros((NUM_SYMBOLS, V), np.int32)
    for sym in range(NUM_SYMBOLS):
        for tok in range(V):
            if not legal[sym, tok]:
                continue
            before = SYMBOL_MIN[sym]
            after = 0 if repl[sym, tok] == POP \
                else SYMBOL_MIN[repl[sym, tok]]
            after += sum(SYMBOL_MIN[p]
                         for p in push_seq[sym, tok, :push_len[sym, tok]])
            delta[sym, tok] = after - before
    return {"legal": legal, "repl": repl, "push_seq": push_seq,
            "push_len": push_len, "delta": delta}


_TABLES = None


def tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = build_tables()
    return _TABLES


def torch_tables(device):
    """Copies of the transition tables on `device` for on-device
    constrained decoding (models/decoder.py): bool stays bool, every other
    table becomes int64 (torch indexes with it)."""
    import torch
    return {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.int64),
                               device=device)
            for k, v in tables().items()}


def initial_stack():
    """Stack bottom-to-top; top expects 'DEF'."""
    return [S_REQ_M, S_M_OPEN, S_RUN, S_DEF]


class PrefixSyntaxError(Exception):
    pass


class KarelSyntaxOracle:
    """Host-side oracle with reference API parity
    (`dsl_syntax.KarelDSLSyntax.get_next_candidates`)."""

    def __init__(self):
        self.vocab = KarelVocab()
        self.t = tables()
        self.int2token = self.vocab.int2token
        self.token2int = self.vocab.token2int

    def intseq2str(self, intseq):
        return self.vocab.intseq2str(intseq)

    def _advance(self, stack, msum, tok):
        t = self.t
        if not stack:
            raise PrefixSyntaxError("tokens after program end")
        top = stack[-1]
        if not t["legal"][top, tok]:
            raise PrefixSyntaxError(
                f"token {self.int2token[tok]!r} illegal with top symbol "
                f"{top}")
        msum += int(t["delta"][top, tok])
        stack = stack[:-1]
        r = int(t["repl"][top, tok])
        if r != POP:
            stack = stack + [r]
        plen = int(t["push_len"][top, tok])
        stack = stack + [int(s) for s in t["push_seq"][top, tok, :plen]]
        return stack, msum

    def run_prefix(self, prefix_ids):
        """-> (stack, msum). Raises PrefixSyntaxError on an illegal prefix."""
        stack = initial_stack()
        msum = int(sum(SYMBOL_MIN[s] for s in stack))
        for tok in prefix_ids:
            stack, msum = self._advance(stack, msum, int(tok))
        return stack, msum

    def next_candidates_ids(self, prefix_ids):
        """-> [(token_id, min_total_including_candidate)]."""
        stack, msum = self.run_prefix(prefix_ids)
        if not stack:
            return []
        top = stack[-1]
        t = self.t
        out = []
        for tok in np.nonzero(t["legal"][top])[0]:
            out.append((int(tok), 1 + msum + int(t["delta"][top, tok])))
        return out

    def get_next_candidates(self, code):
        """Reference API: program prefix string -> [(token_str, count)]."""
        ids = [self.token2int[t] for t in code.split()]
        return [(self.int2token[tok], cnt)
                for tok, cnt in self.next_candidates_ids(ids)]

    def legal_mask(self, prefix_ids, max_program_len):
        """bool mask over the vocab, budget-filtered like
        `seq2seq_helper.py:252-254`."""
        mask = np.zeros(len(self.int2token), bool)
        try:
            cands = self.next_candidates_ids(prefix_ids)
        except PrefixSyntaxError:
            mask[:] = True  # reference fallback: allow everything (:255-258)
            return mask
        budget = max_program_len - len(prefix_ids)
        for tok, cnt in cands:
            if cnt <= budget:
                mask[tok] = True
        return mask
