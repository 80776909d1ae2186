"""The port's own copies of the framework-free layers vs their JAX-package
originals, on the CPU: the Karel DSL (parser, interpreter, canonical forms,
bytecode, sampler, syntax tables), the grid world, the HDF5 reader and the
CLI flags. Every output must be identical.

Programs: 200 from the sampler plus garbage strings (empty, truncated,
shuffled, unknown tokens); worlds from KarelStateGenerator at one seed.
"""

import shutil

import numpy as np
import pytest

from demo2program_tpu.cli import flags as jax_flags
from demo2program_tpu.data import dataset as jax_dataset
from demo2program_tpu.data.karel_generator import GeneratorConfig, generate
from demo2program_tpu.dsl import (
    karel_ast as jax_ast, karel_bytecode as jax_bytecode,
    karel_canonical as jax_canonical, karel_interp as jax_interp,
    karel_parser as jax_parser, karel_syntax as jax_syntax,
    karel_vocab as jax_vocab)
from demo2program_tpu.dsl.karel_sampler import (
    KarelProgramSampler as JaxSampler)
from demo2program_tpu.envs import karel as jax_env
from demo2program_tpu_torch.cli import flags
from demo2program_tpu_torch.data import dataset
from demo2program_tpu_torch.dsl import (
    karel_ast, karel_bytecode, karel_canonical, karel_interp, karel_parser,
    karel_syntax, karel_vocab)
from demo2program_tpu_torch.dsl.karel_sampler import KarelProgramSampler
from demo2program_tpu_torch.envs import karel as env

N_PROGRAMS = 200


def _programs():
    sampler = JaxSampler(seed=17)
    progs = [sampler.random_code() for _ in range(N_PROGRAMS)]
    r = np.random.RandomState(4)
    garbage = ["", "DEF", "DEF run m(", "DEF run m( m)", "run m( move m)",
               "DEF run m( move", "DEF run m( jump m)",
               "DEF run m( WHILE c( frontIsClear c) w( move w) m)",
               "DEF run m( REPEAT R=3 r( turnLeft r) m) m)"]
    for p in progs[:40]:
        toks = p.split()
        garbage.append(" ".join(toks[:r.randint(1, len(toks))]))
        r.shuffle(toks)
        garbage.append(" ".join(toks))
    return progs, garbage


PROGRAMS, GARBAGE = _programs()
ALL = PROGRAMS + GARBAGE


def _worlds(n, seed=3):
    gen_j, gen_t = jax_env.KarelStateGenerator(seed), env.KarelStateGenerator(
        seed)
    out = []
    for _ in range(n):
        s_j, s_t = gen_j.generate_single_state(), gen_t.generate_single_state()
        for a, b in zip(s_j, s_t):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        out.append(s_t[0])
    return out


def test_vocab_is_the_same():
    v_j, v_t = jax_vocab.KarelVocab(), karel_vocab.KarelVocab()
    assert v_j.int2token == v_t.int2token
    assert v_j.token2int == v_t.token2int
    assert v_j.end_token == v_t.end_token
    for p in PROGRAMS[:20]:
        assert v_t.str2intseq(p) == v_j.str2intseq(p)


@pytest.mark.parametrize("code", ALL[:5] + GARBAGE[:10])
def test_parse_never_raises_on_garbage(code):
    """parse returns (None, False) on garbage, never raises."""
    ast, ok = karel_parser.parse(code)
    assert (ast is None) == (not ok)


def test_parser_matches_jax():
    """Same verdict and the same token rendering of the AST."""
    for code in ALL:
        ast_j, ok_j = jax_parser.parse(code)
        ast_t, ok_t = karel_parser.parse(code)
        assert ok_t == ok_j, code
        if ok_j:
            assert karel_ast.to_tokens(ast_t) == jax_ast.to_tokens(ast_j)
            assert repr(ast_t) == repr(ast_j)
    assert sum(karel_parser.parse(c)[1] for c in PROGRAMS) == N_PROGRAMS


def test_interpreter_histories_match_jax():
    """run_string on the same world: verdict, call count, success and the
    whole state, action and perception history."""
    worlds = _worlds(8)
    for i, code in enumerate(ALL):
        s = worlds[i % len(worlds)]
        w_j, w_t = jax_env.KarelWorld(s), env.KarelWorld(s)
        assert karel_interp.run_string(w_t, code) == \
            jax_interp.run_string(w_j, code), code
        assert w_t.a_h == w_j.a_h
        np.testing.assert_array_equal(np.array(w_t.s_h), np.array(w_j.s_h))
        np.testing.assert_array_equal(np.array(w_t.p_v_h),
                                      np.array(w_j.p_v_h))


def test_call_budget_contract():
    """An infinite WHILE fails with n = 101 and exactly 98 recorded
    actions, in both packages."""
    code = "DEF run m( WHILE c( noMarkersPresent c) w( turnLeft w) m)"
    s = _worlds(1)[0]
    s[:, :, 5] = True   # no markers anywhere
    s[:, :, 6:] = False
    for interp, world in ((karel_interp, env.KarelWorld(s)),
                          (jax_interp, jax_env.KarelWorld(s))):
        assert interp.run_string(world, code) == (True, 101, False)
        assert len(world.a_h) == 98
    assert karel_interp.MAX_FUNC_CALL == jax_interp.MAX_FUNC_CALL


def test_canonical_forms_match_jax():
    """programs_equal on pairs of programs and the digests; the port's
    STATS counters are its own and count the same."""
    karel_canonical.STATS.update(compares=0, cap_fallbacks=0)
    jax_canonical.STATS.update(compares=0, cap_fallbacks=0)
    for a, b in zip(PROGRAMS, PROGRAMS[1:] + PROGRAMS[:1]):
        for x, y in ((a, a), (a, b)):
            assert karel_canonical.programs_equal(x, y) == \
                jax_canonical.programs_equal(x, y)
        assert karel_canonical.canonical_digest(a) == \
            jax_canonical.canonical_digest(a)
    assert karel_canonical.STATS == jax_canonical.STATS
    assert karel_canonical.STATS is not jax_canonical.STATS
    assert karel_canonical.STATS["compares"] > 0


def test_bytecode_matches_jax():
    v_j, v_t = jax_vocab.KarelVocab(), karel_vocab.KarelVocab()
    rows = [v_t.str2intseq(c) if karel_parser.parse(c)[1] else
            [v_t.token2int.get(t, 0) for t in c.split()] for c in ALL]
    L = max(len(r) for r in rows) + 1
    ids = np.zeros((len(rows), L), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    lens = np.array([len(r) for r in rows])
    codes_t, ok_t = karel_bytecode.compile_batch(ids, lens, v_t)
    codes_j, ok_j = jax_bytecode.compile_batch(ids, lens, v_j)
    np.testing.assert_array_equal(codes_t, codes_j)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_t[:N_PROGRAMS].all()
    assert karel_bytecode.MAX_LOOP_DEPTH == jax_bytecode.MAX_LOOP_DEPTH


def test_sampler_matches_jax():
    s_j, s_t = JaxSampler(seed=5), KarelProgramSampler(seed=5)
    for _ in range(100):
        assert s_t.random_code() == s_j.random_code()


def test_syntax_tables_match_jax():
    t_j, t_t = jax_syntax.tables(), karel_syntax.tables()
    assert set(t_t) == set(t_j)
    for k in t_j:
        np.testing.assert_array_equal(t_t[k], t_j[k], err_msg=k)
        assert t_t[k].dtype == t_j[k].dtype
    dev = karel_syntax.torch_tables("cpu")
    for k in t_j:
        np.testing.assert_array_equal(dev[k].numpy(), t_j[k], err_msg=k)
    assert karel_syntax.initial_stack() == jax_syntax.initial_stack()
    for name in ("POP", "STACK_DEPTH", "NUM_SYMBOLS", "MAX_PUSH"):
        assert getattr(karel_syntax, name) == getattr(jax_syntax, name)
    np.testing.assert_array_equal(karel_syntax.SYMBOL_MIN,
                                  jax_syntax.SYMBOL_MIN)


def test_state_generator_and_world_match_jax():
    """Single states, vectorised batches and world transitions."""
    _worlds(20, seed=9)
    g_j, g_t = jax_env.KarelStateGenerator(2), env.KarelStateGenerator(2)
    batch_j, batch_t = g_j.generate_batch(16), g_t.generate_batch(16)
    for a, b in zip(batch_j, batch_t):
        np.testing.assert_array_equal(a, b)
    states = env.batch_to_states(*batch_t)
    np.testing.assert_array_equal(states, jax_env.batch_to_states(*batch_j))
    r = np.random.RandomState(0)
    for s in states:
        w_j, w_t = jax_env.KarelWorld(s), env.KarelWorld(s, make_error=False)
        w_j.make_error = False
        for a in r.randint(0, 5, 30):
            w_j.state_transition(a)
            w_t.state_transition(a)
        np.testing.assert_array_equal(w_t.s, w_j.s)
        assert w_t.a_h == w_j.a_h
    with pytest.raises(ValueError):
        env.KarelWorld(np.zeros((8, 8, 16), bool))
    assert env.NUM_STATE_CHANNELS == jax_env.NUM_STATE_CHANNELS
    assert env.PERCEPTION_NAMES == jax_env.PERCEPTION_NAMES


def test_hdf5_reader_matches_jax(tmp_path):
    """create_default_splits on one tiny generated dataset, read by each
    package from its own copy (so each builds its own compact cache): the
    same split ids, metadata and compact batches, bit for bit."""
    a = str(tmp_path / "port")
    generate(GeneratorConfig(
        dir_name=a, num_train=6, num_test=4, num_val=2, seed=9,
        num_demo_per_program=4, num_test_demo_per_program=2,
        min_demo_length=3, max_demo_length=8), progress_every=0,
        backend="python")
    b = str(tmp_path / "jax")
    shutil.copytree(a, b)
    splits_t = dataset.create_default_splits(a, num_k=3)
    splits_j = jax_dataset.create_default_splits(b, num_k=3)
    for s_t, s_j in zip(splits_t, splits_j):
        assert s_t.ids == s_j.ids and len(s_t) > 0
        for attr in ("dsl_type", "env_type", "num_demo", "max_demo_len",
                     "max_program_len"):
            assert getattr(s_t, attr) == getattr(s_j, attr), attr
        got = s_t.get_batch_compact(s_t.ids)
        want = s_j.get_batch_compact(s_j.ids)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flags_match_jax():
    """One argv through both packages' parsers: the same namespace; the
    defaults too."""
    argv = ["--model", "summarizer", "--num_k", "4", "--batch_size", "7",
            "--scheduled_sampling", "--scheduled_sampling_decay_steps", "9",
            "--cell_impl", "pallas", "--learning_rate", "0.01",
            "--lr_weight_decay", "--max_steps", "3"]
    for args in (argv, []):
        got = flags.add_train_flags(flags.base_parser()).parse_args(args)
        want = jax_flags.add_train_flags(
            jax_flags.base_parser()).parse_args(args)
        assert vars(got) == vars(want)
