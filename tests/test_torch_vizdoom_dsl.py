"""The port's ViZDoom layers without a model vs their JAX-package originals,
on the CPU: the DSL (vocab, parser, interpreter, canonical forms, sampler),
the DoomLite engine and the Vizdoom_env wrapper, area_resize against cv2's
INTER_AREA, the dataset generator (HDF5 and in memory) and the HDF5
reader. Every output must be identical, frames bit for bit.

Programs: sampled by both packages' samplers against DoomLite worlds from
one seed, plus garbage strings (empty, truncated, shuffled, unknown
tokens).
"""

import cv2
import h5py
import numpy as np
import pytest

from demo2program_tpu.data import vizdoom_dataset as jax_dataset
from demo2program_tpu.data import vizdoom_generator as jax_generator
from demo2program_tpu.dsl import (
    vizdoom_canonical as jax_canonical, vizdoom_interp as jax_interp,
    vizdoom_parser as jax_parser, vizdoom_vocab as jax_vocab)
from demo2program_tpu.dsl.vizdoom_sampler import (
    DoomProgramGenerator as JaxSampler)
from demo2program_tpu.envs import doomlite as jax_doomlite
from demo2program_tpu.envs import vizdoom as jax_env
from demo2program_tpu_torch.data import (
    vizdoom_dataset, vizdoom_generator, vizdoom_memory)
from demo2program_tpu_torch.dsl import (
    vizdoom_canonical, vizdoom_interp, vizdoom_parser, vizdoom_vocab)
from demo2program_tpu_torch.dsl.vizdoom_sampler import DoomProgramGenerator
from demo2program_tpu_torch.envs import doomlite
from demo2program_tpu_torch.envs import vizdoom as env
from demo2program_tpu_torch.utils.area_resize import area_resize

N_WORLDS, N_PROGRAMS = 3, 24
GEN = dict(num_train=4, num_test=2, num_val=1, seed=7,
           num_demo_per_program=5, num_test_demo_per_program=2)


def _world(module):
    w = module.Vizdoom_env(perception_type="simple", engine="doomlite")
    w.init_game()
    return w


def _initial_states(n, seed=3):
    gen = jax_generator.DoomStateGenerator(seed=seed)
    return [gen.generate_initial_state() for _ in range(n)]


def _sample(sampler_cls, module, n=N_PROGRAMS):
    worlds = [_world(module) for _ in range(N_WORLDS)]
    sampler = sampler_cls(seed=5)
    states = _initial_states(n * N_WORLDS)
    percepts = worlds[0].get_perception_vector_cond()
    out = []
    for i in range(n):
        for w, s in zip(worlds, states[i * N_WORLDS:(i + 1) * N_WORLDS]):
            w.new_episode(s)
        out.append(sampler.random_code(percepts, worlds))
    return out


@pytest.fixture(scope="module")
def programs():
    sampled = _sample(JaxSampler, jax_env)
    progs = [p for p, ok in sampled if ok]
    r = np.random.RandomState(4)
    garbage = ["", "DEF", "DEF run m(", "DEF run m( m)",
               "run m( ATTACK m)", "DEF run m( ATTACK",
               "DEF run m( JUMP m)", "DEF run m( IF c( ISTHERE Demon c) "
               "i( ATTACK i) m) m)",
               "DEF run m( WHILE c( not c( not c( ISTHERE Demon c) c) c) "
               "w( ATTACK w) m)"]
    for p in progs[:10]:
        toks = p.split()
        garbage.append(" ".join(toks[:r.randint(1, len(toks))]))
        r.shuffle(toks)
        garbage.append(" ".join(toks))
    return sampled, progs, garbage


@pytest.mark.parametrize("perception_type,level", [
    ("simple", "not_simple"), ("more_simple", "not_simple"),
    ("clear", "not_simple"), ("basic", "not_simple"), ("simple", "simple")])
def test_vocab_tables_match_jax(perception_type, level, programs):
    v_j = jax_vocab.VizDoomDSLVocab(perception_type, level)
    v_t = vizdoom_vocab.VizDoomDSLVocab(perception_type, level)
    for attr in ("int2token", "token2int", "action_int2token",
                 "action_token2int", "end_token"):
        assert getattr(v_t, attr) == getattr(v_j, attr), attr
    if (perception_type, level) == ("simple", "not_simple"):
        for p in programs[1]:
            assert v_t.str2intseq(p) == v_j.str2intseq(p)
            assert v_t.intseq2str(v_t.str2intseq(p)) == p


def test_sampler_matches_jax(programs):
    """Both samplers, one seed, equal worlds: the same programs (and the
    same rejections)."""
    assert _sample(DoomProgramGenerator, env) == programs[0]
    assert len(programs[1]) >= N_PROGRAMS // 2


def test_parser_matches_jax(programs):
    _, progs, garbage = programs
    for code in progs + garbage:
        ast_t, ok_t = vizdoom_parser.parse(code)
        ast_j, ok_j = jax_parser.parse(code)
        assert ok_t == ok_j, code
        assert repr(ast_t) == repr(ast_j), code
    assert sum(not vizdoom_parser.parse(g)[1] for g in garbage) >= 10


def test_canonical_forms_match_jax(programs):
    _, progs, garbage = programs
    pool = progs[:12] + garbage[:6]
    for a in pool:
        assert repr(vizdoom_canonical.parse(a)) == repr(
            jax_canonical.parse(a)), a
        for b in pool[:8]:
            assert vizdoom_canonical.programs_equal(a, b) == \
                jax_canonical.programs_equal(a, b), (a, b)


def test_interpreter_histories_match_jax(programs):
    """Each program on a DoomLite world of each package from the same
    initial state: the same success, frames, actions and percepts."""
    w_t, w_j = _world(env), _world(jax_env)
    states = _initial_states(len(programs[1]), seed=9)
    for code, s in zip(programs[1], states):
        w_t.new_episode(s)
        w_j.new_episode(s)
        _, ok_t = vizdoom_interp.execute(vizdoom_parser.parse(code)[0], w_t)
        _, ok_j = jax_interp.execute(jax_parser.parse(code)[0], w_j)
        assert ok_t == ok_j, code
        assert w_t.a_h == w_j.a_h, code
        assert len(w_t.s_h) == len(w_j.s_h)
        for a, b in zip(w_t.s_h + w_t.p_v_h, w_j.s_h + w_j.p_v_h):
            np.testing.assert_array_equal(a, b)


def _labels(state):
    return [(lb.object_name, lb.object_id, lb.x, lb.y, lb.width, lb.height)
            for lb in state.labels]


@pytest.mark.parametrize("style", ["v2", "v3"])
def test_doomlite_frames_and_labels_match_jax(style):
    """DoomLite itself: random button vectors from one initial layout, the
    screen buffer, game variables and labels bit for bit."""
    games = []
    for module in (doomlite, jax_doomlite):
        g = module.DoomGame()
        g.set_sprite_style(style)
        g.load_config(None)
        g.init()
        g.new_episode()
        games.append(g)
    r = np.random.RandomState(2)
    n_buttons = len(games[0].get_available_buttons())
    for _ in range(30):
        vec = (r.rand(n_buttons) < 0.2).tolist()
        tics = int(r.randint(1, 5))
        for g in games:
            g.make_action(vec, tics)
        st_t, st_j = (g.get_state() for g in games)
        np.testing.assert_array_equal(st_t.screen_buffer, st_j.screen_buffer)
        np.testing.assert_array_equal(st_t.game_variables,
                                      st_j.game_variables)
        assert _labels(st_t) == _labels(st_j)


def test_env_histories_match_jax():
    """Vizdoom_env over every macro action, from seeded layouts: frames,
    percepts and actions bit for bit."""
    w_t, w_j = _world(env), _world(jax_env)
    r = np.random.RandomState(6)
    actions = sorted(env.FRAME_SKIP)
    for s in _initial_states(3, seed=12):
        w_t.new_episode(s)
        w_j.new_episode(s)
        for _ in range(12):
            a = actions[r.randint(len(actions))]
            w_t.state_transition(a)
            w_j.state_transition(a)
        assert w_t.a_h == w_j.a_h
        for a, b in zip(w_t.s_h + w_t.p_v_h, w_j.s_h + w_j.p_v_h):
            np.testing.assert_array_equal(a, b)


def _doomlite_frames():
    w = _world(env)
    r = np.random.RandomState(8)
    actions = sorted(env.FRAME_SKIP)
    frames = []
    for s in _initial_states(4, seed=21):
        w.new_episode(s)
        for _ in range(10):
            w.state_transition(actions[r.randint(len(actions))])
        frames += w.s_h
    return np.stack(frames)


@pytest.mark.parametrize("source", ["doomlite", "random", "bands"])
def test_area_resize_matches_cv2(source):
    """area_resize == cv2.resize(..., INTER_AREA) bit for bit: every frame
    of seeded DoomLite episodes (160x120 -> 80x80), random images of that
    shape, and images of few levels, where ties of the rounding are
    common."""
    r = np.random.RandomState(3)
    if source == "doomlite":
        imgs = _doomlite_frames()
    elif source == "random":
        imgs = r.randint(0, 256, (40, 120, 160, 3)).astype(np.uint8)
    else:
        imgs = (r.randint(0, 4, (40, 120, 160, 3)) * 85).astype(np.uint8)
    want = np.stack([cv2.resize(im, (80, 80), interpolation=cv2.INTER_AREA)
                     for im in imgs])
    np.testing.assert_array_equal(area_resize(imgs, (80, 80)), want)
    for im, w in zip(imgs[:5], want):  # one image at a time too
        np.testing.assert_array_equal(area_resize(im, (80, 80)), w)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One tiny dataset written by each package's generator, same seed."""
    root = tmp_path_factory.mktemp("vizdoom")
    jax_generator.generate(jax_generator.VizdoomGeneratorConfig(
        dir_name=str(root / "jax"), **GEN))
    vizdoom_generator.generate(vizdoom_generator.VizdoomGeneratorConfig(
        dir_name=str(root / "port"), **GEN))
    return str(root / "jax"), str(root / "port")


def _h5_contents(path):
    out = {}
    with h5py.File(path + "/data.hdf5", "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, (obj[()], obj.dtype)) if isinstance(obj, h5py.Dataset)
            else None)
    return out


def test_generator_matches_jax(datasets):
    """The port's HDF5 equals the JAX generator's: every dataset of every
    group and of data_info, values and dtypes; id.txt too."""
    jax_dir, port_dir = datasets
    want, got = _h5_contents(jax_dir), _h5_contents(port_dir)
    assert set(got) == set(want)
    for name, (value, dtype) in want.items():
        assert got[name][1] == dtype, name
        np.testing.assert_array_equal(got[name][0], value, err_msg=name)
    assert open(port_dir + "/id.txt").read() == open(
        jax_dir + "/id.txt").read()


def test_reader_and_memory_split_match_jax(datasets):
    """get_data of the port's reader (and of the in-memory split from the
    same seed) equals the JAX reader's on the JAX generator's file, every
    split and item, at num_k 3."""
    jax_dir, _ = datasets
    splits_j = jax_dataset.create_vizdoom_splits(jax_dir, num_k=3)
    splits_t = vizdoom_dataset.create_vizdoom_splits(jax_dir, num_k=3)
    memory = vizdoom_memory.generate_split(
        vizdoom_generator.VizdoomGeneratorConfig(**GEN))
    memory.num_k = 3
    for s_j, s_t in zip(splits_j, splits_t):
        assert s_t.ids == s_j.ids
        for attr in ("max_demo_len", "max_program_len", "num_program_tokens",
                     "num_action_tokens", "vizdoom_pos_keys",
                     "vizdoom_max_init_pos_len", "perception_type", "level",
                     "sprite_style", "test_k", "s_h_h", "s_h_w", "s_h_c"):
            assert getattr(s_t, attr) == getattr(s_j, attr), attr
            assert getattr(memory, attr) == getattr(s_j, attr), attr
        for id_ in s_j.ids:
            want = s_j.get_data(id_)
            for got in (s_t.get_data(id_), memory.get_data(id_)):
                assert set(got) == set(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                    assert np.asarray(got[k]).dtype == np.asarray(
                        want[k]).dtype, k
