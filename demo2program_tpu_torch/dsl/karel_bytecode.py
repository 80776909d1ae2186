"""Karel AST -> bytecode compiler for the vectorized on-device VM.

The port's own copy of demo2program_tpu/dsl/karel_bytecode.py (numpy and
the standard library only), so the port imports nothing of the JAX
package.

The reference scores execution accuracy by replaying each predicted program
serially inside tf.py_func (`model_full.py:747-787`) — one Python interpreter
rollout per (batch element x demo). We instead compile programs to a dense
integer bytecode and execute the whole (batch x k) grid of rollouts in
parallel on the device (ops/vm.py).

The instruction stream embeds the reference interpreter's *call-budget*
checkpoints exactly (see dsl/karel_interp.py for the transcription from
`karel_env/dsl/dsl_parse.py`), so VM success/failure — and therefore
execution accuracy — bit-matches the host interpreter. Property-tested in
tests/test_vm.py.

Instruction set ((opcode, arg) int32 pairs):

  HALT           program completed successfully
  BUDGET inc     n += inc; if n > MAX_FUNC_CALL: fail       (check-points)
  INC    inc     n += inc                                   (repeat entry)
  ACT    a       perform env action a (0..4); env error -> fail (or no-op
                 with make_error=False); records a state
  EVAL   p       C := percept p (0..4)
  NEGC           C := not C
  JMP    addr    unconditional jump
  JMPF   addr    jump when C is False
  PUSHCTR m      push loop counter m
  JZDEC  addr    if top counter == 0: pop, jump addr; else decrement
"""

import numpy as np

from demo2program_tpu_torch.dsl import karel_ast as A
from demo2program_tpu_torch.dsl import karel_parser
from demo2program_tpu_torch.dsl.karel_vocab import (
    ACTION_TOKEN_TO_ENV, PERCEPT_TOKENS)

OP_HALT = 0
OP_BUDGET = 1
OP_INC = 2
OP_ACT = 3
OP_EVAL = 4
OP_NEGC = 5
OP_JMP = 6
OP_JMPF = 7
OP_PUSHCTR = 8
OP_JZDEC = 9
NUM_OPS = 10

# generous default: <= ~3 instructions per token + fixed preamble
DEFAULT_MAX_CODE_LEN = 256
MAX_LOOP_DEPTH = 8  # max nesting is 4 in sampled data; predictions may nest
                    # deeper — overflow is compiled-out (see compile_tokens)

_PERCEPT_ID = {t: i for i, t in enumerate(PERCEPT_TOKENS)}


class BytecodeTooLong(Exception):
    pass


class _Emitter:
    def __init__(self):
        self.code = []

    def emit(self, op, arg=0):
        self.code.append([op, arg])
        return len(self.code) - 1

    def patch(self, idx, arg):
        self.code[idx][1] = arg

    def here(self):
        return len(self.code)


def _emit_cond(e, node, pre_inc):
    """cond called as `cond(k, n+pre_inc)`: increment then the cond node's
    entry check (karel_interp._eval_cond)."""
    e.emit(OP_BUDGET, pre_inc)
    _emit_cond_body(e, node)


def _emit_cond_body(e, node):
    if isinstance(node, A.Percept):
        e.emit(OP_EVAL, _PERCEPT_ID[node.token])
        return
    if isinstance(node, A.Not):
        # nested cond entry checks are no-ops (same n) — collapsed
        _emit_cond_body(e, node.cond)
        e.emit(OP_NEGC)
        return
    raise TypeError(node)


def _emit_stmt(e, node, pre_inc, depth):
    """stmt wrapper called as `wrapper(node, n+pre_inc)`: increment + wrapper
    entry check, then inner call with n+1 + inner entry check
    (karel_interp._exec_stmt_wrapper)."""
    e.emit(OP_BUDGET, pre_inc)
    e.emit(OP_BUDGET, 1)
    _emit_inner(e, node, depth)


def _emit_inner(e, node, depth):
    if isinstance(node, A.Action):
        e.emit(OP_ACT, ACTION_TOKEN_TO_ENV[node.token])
        return
    if isinstance(node, A.Seq):
        _emit_stmt(e, node.first, 1, depth)
        e.emit(OP_BUDGET, 0)  # re-check between stmts (dsl_parse.py:57)
        _emit_stmt(e, node.second, 0, depth)
        return
    if isinstance(node, A.If):
        _emit_cond(e, node.cond, 1)
        j = e.emit(OP_JMPF)
        _emit_stmt(e, node.body, 0, depth)
        e.patch(j, e.here())
        return
    if isinstance(node, A.IfElse):
        _emit_cond(e, node.cond, 1)
        j_else = e.emit(OP_JMPF)
        _emit_stmt(e, node.body, 0, depth)
        j_end = e.emit(OP_JMP)
        e.patch(j_else, e.here())
        _emit_stmt(e, node.else_body, 0, depth)
        e.patch(j_end, e.here())
        return
    if isinstance(node, A.While):
        l_cond = e.here()
        _emit_cond(e, node.cond, 0)
        j_end = e.emit(OP_JMPF)
        _emit_stmt(e, node.body, 0, depth)
        e.emit(OP_JMP, l_cond)
        e.patch(j_end, e.here())
        return
    if isinstance(node, A.Repeat):
        if depth + 1 > MAX_LOOP_DEPTH:
            raise BytecodeTooLong("loop counter stack overflow")
        e.emit(OP_INC, 1)  # r_repeat increments without checking (:106-117)
        e.emit(OP_PUSHCTR, node.count)
        l_top = e.here()
        j_end = e.emit(OP_JZDEC)
        _emit_stmt(e, node.body, 0, depth + 1)
        e.emit(OP_JMP, l_top)
        e.patch(j_end, e.here())
        return
    raise TypeError(node)


def compile_ast(ast, max_code_len=DEFAULT_MAX_CODE_LEN):
    """Program AST -> (max_code_len, 2) int32 bytecode array."""
    e = _Emitter()
    e.emit(OP_BUDGET, 0)  # execute() entry check at n=0
    _emit_stmt(e, ast.body, 1, 0)  # prog calls its stmt with n+1
    e.emit(OP_HALT)
    if len(e.code) > max_code_len:
        raise BytecodeTooLong(
            f"{len(e.code)} instructions > max_code_len={max_code_len}")
    code = np.zeros([max_code_len, 2], dtype=np.int32)
    code[:len(e.code)] = np.array(e.code, dtype=np.int32)
    # padding is OP_HALT(0) — unreachable, but safe
    return code


def compile_tokens(token_ids, vocab, max_code_len=DEFAULT_MAX_CODE_LEN):
    """Token-id sequence -> (bytecode, ok). ok=False on syntax error or
    un-compilable program (too long / loop stack overflow); such programs
    score zero execution accuracy, exactly like the reference's
    is_correct_syntax gating (`model_full.py:760`)."""
    code_str = vocab.intseq2str(token_ids)
    ast, ok = karel_parser.parse(code_str)
    if not ok:
        return np.zeros([max_code_len, 2], dtype=np.int32), False
    try:
        return compile_ast(ast, max_code_len), True
    except BytecodeTooLong:
        return np.zeros([max_code_len, 2], dtype=np.int32), False


def compile_batch(token_id_rows, lengths, vocab,
                  max_code_len=DEFAULT_MAX_CODE_LEN):
    """[(bs, L_prog)] padded token ids + lengths -> (bs, max_code_len, 2)
    bytecode + (bs,) ok flags."""
    bs = len(token_id_rows)
    codes = np.zeros([bs, max_code_len, 2], dtype=np.int32)
    oks = np.zeros([bs], dtype=bool)
    for i in range(bs):
        ids = token_id_rows[i][:int(lengths[i])]
        codes[i], oks[i] = compile_tokens(ids, vocab, max_code_len)
    return codes, oks
