"""The port's last three tools against the JAX package's, on the same
inputs (tests/test_tools.py drives the JAX ones): `hit_analysis.hit_count`
on Karel and ViZDoom (DoomLite) programs and worlds,
`measure_program_fix_accuracy` (levenshtein, sweep, and `main` over a
result dump of a Karel and of a ViZDoom dataset, printed lines equal) and
`doom_error_analysis` (classify, and `main` over an evaler dump with its
.hdf5 execution bits)."""

import contextlib
import io
import os

import h5py
import numpy as np
import pytest

from demo2program_tpu.data.karel_generator import GeneratorConfig, generate
from demo2program_tpu.data.vizdoom_generator import (
    VizdoomGeneratorConfig, generate as vizdoom_generate)
from demo2program_tpu.envs import vizdoom as jax_vizdoom
from demo2program_tpu.envs.karel import KarelWorld as JaxKarelWorld
from demo2program_tpu.tools import doom_error_analysis as jax_doom_errors
from demo2program_tpu.tools import hit_analysis as jax_hits
from demo2program_tpu.tools import measure_program_fix_accuracy as jax_fix
from demo2program_tpu_torch.dsl.karel_sampler import KarelProgramSampler
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.dsl.vizdoom_sampler import DoomProgramGenerator
from demo2program_tpu_torch.dsl.vizdoom_vocab import VizDoomDSLVocab
from demo2program_tpu_torch.envs import vizdoom
from demo2program_tpu_torch.envs.karel import KarelStateGenerator, KarelWorld
from demo2program_tpu_torch.tools import (
    doom_error_analysis, hit_analysis, measure_program_fix_accuracy as fix)

KAREL_CODES = [
    "DEF run m( IFELSE c( markersPresent c) i( pickMarker i) "
    "ELSE e( turnLeft e) m)",
    "DEF run m( WHILE c( markersPresent c) w( pickMarker w) m)",
    "DEF run m( REPEAT R=3 r( move putMarker r) IF c( not c( "
    "frontIsClear c) c) i( turnRight i) m)",
]


def _same_hits(got, want):
    """(hits, n, success) of both interpreters."""
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])


def test_hit_count_matches_jax_karel():
    """Hand-written programs and sampled ones on random grids: per-token
    hit counts, call count and success equal; a program that does not
    parse is refused by both."""
    codes = KAREL_CODES + [KarelProgramSampler(seed=4).random_code()
                           for _ in range(12)]
    gen = KarelStateGenerator(seed=2)
    states = [gen.generate_single_state()[0] for _ in range(4)]
    for code in codes:
        exe, ok = hit_analysis.hit_count(code, domain="karel")
        jexe, jok = jax_hits.hit_count(code, domain="karel")
        assert ok == jok, code
        for s in states:
            _same_hits(exe(KarelWorld(s.copy())),
                       jexe(JaxKarelWorld(s.copy())))
    assert hit_analysis.hit_count("not a program", "karel") == (None, False)


def _doom_world(module):
    w = module.Vizdoom_env(perception_type="simple", engine="doomlite")
    w.init_game()
    return w


def test_hit_count_matches_jax_vizdoom():
    """Sampled ViZDoom programs on seeded DoomLite layouts, one world per
    package: hit counts, call count and success equal."""
    from demo2program_tpu.data.vizdoom_generator import DoomStateGenerator

    world, jworld = _doom_world(vizdoom), _doom_world(jax_vizdoom)
    gen = DoomStateGenerator(seed=3)
    sampler = DoomProgramGenerator(seed=5)
    percepts = world.get_perception_vector_cond()
    for _ in range(6):
        state = gen.generate_initial_state()
        world.new_episode(state)
        code, _ = sampler.random_code(percepts, [world])
        exe, ok = hit_analysis.hit_count(code, "vizdoom")
        jexe, jok = jax_hits.hit_count(code, "vizdoom")
        assert ok and jok, code
        world.new_episode(state)
        jworld.new_episode(state)
        _same_hits(exe(world), jexe(jworld))


def test_levenshtein_and_sweep_match_jax():
    r = np.random.RandomState(0)
    for _ in range(20):
        a = list(r.randint(0, 4, r.randint(0, 9)))
        b = list(r.randint(0, 4, r.randint(0, 9)))
        assert fix.levenshtein(a, b) == jax_fix.levenshtein(a, b)
    seq, exe = r.rand(30) < 0.3, r.rand(30) < 0.5
    dist = r.randint(0, 25, 30)
    assert fix.sweep(seq, exe, dist) == jax_fix.sweep(seq, exe, dist)


def _result_dump(data_dir, vocab_size, path, seed=0):
    """A result.hdf5 of one-hot predictions of every test id of the
    dataset: the ground truth, or it with 1-3 tokens replaced."""
    r = np.random.RandomState(seed)
    with open(os.path.join(data_dir, "id.txt")) as f:
        ids = [line.strip() for line in f if line.strip()][-6:]
    with h5py.File(os.path.join(data_dir, "data.hdf5"), "r") as fd, \
            h5py.File(path, "w") as fo:
        for i, did in enumerate(ids):
            tokens = np.array(fd[did]["program"][()])
            if i % 2:
                where = r.choice(len(tokens), min(len(tokens), 1 + i % 3),
                                 replace=False)
                tokens[where] = r.randint(0, vocab_size, len(where))
            onehot = np.zeros((vocab_size, len(tokens) + 2), np.float32)
            onehot[tokens, np.arange(len(tokens))] = 1.0
            grp = fo.create_group(did)
            grp["pred_program"] = onehot
            grp["pred_program_len"] = len(tokens)


def _printed(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("domain", ["karel", "vizdoom"])
def test_program_fix_main_matches_jax(tmp_path, domain):
    """`main` of both tools on one result dump prints the same 20 lines:
    execution by the port's VM (Karel, on the CPU) or DoomLite replays
    (ViZDoom) against the JAX package's."""
    data = str(tmp_path / "data")
    if domain == "karel":
        generate(GeneratorConfig(
            dir_name=data, num_train=4, num_test=6, num_val=0,
            num_demo_per_program=3, num_test_demo_per_program=3,
            min_demo_length=4, max_demo_length=10, seed=11),
            progress_every=0)
        vocab_size, extra = len(KarelVocab().int2token), ["--device", "cpu"]
        jax_extra = []
    else:
        vizdoom_generate(VizdoomGeneratorConfig(
            dir_name=data, num_train=2, num_test=6, num_val=0, seed=7,
            num_demo_per_program=3, num_test_demo_per_program=2))
        vocab_size = len(VizDoomDSLVocab(perception_type="simple").int2token)
        extra = ["--dataset_type", "vizdoom"]
        jax_extra = extra + ["--engine_config", os.path.join(
            os.path.dirname(jax_vizdoom.__file__), "..", "assets",
            "doomlite.cfg")]
    result = str(tmp_path / "result.hdf5")
    _result_dump(data, vocab_size, result)
    argv = ["--result_file", result, "--data_file",
            os.path.join(data, "data.hdf5")]
    got = _printed(fix.main, argv + extra)
    want = _printed(jax_fix.main, argv + jax_extra)
    assert len(got) == 20 and got == want
    assert got[0] != got[-1]  # the dump has corrupted programs


def test_doom_error_analysis_matches_jax(tmp_path):
    """classify on each kind of error, and `main` on an evaler dump with
    its .hdf5 execution bits, for both decodes."""
    gt = "DEF run m( IF c( ISTHERE Revenant c) i( MOVE_LEFT i) m)".split()
    species = [t if t != "Revenant" else "Demon" for t in gt]
    predicate = [t if t != "ISTHERE" else "INTARGET" for t in gt]
    structural = [t if t != "MOVE_LEFT" else "ATTACK" for t in gt]
    mixed = [t if t != "Revenant" else "Demon" for t in predicate]
    for pred in (gt, species, predicate, structural, mixed, gt[:-2]):
        assert doom_error_analysis.classify(gt, pred) == \
            jax_doom_errors.classify(gt, pred)

    dump = tmp_path / "out_1_test.txt"
    lines = []
    for i, (pred, greedy) in enumerate([(gt, species), (structural, gt),
                                        (predicate, mixed),
                                        (gt, structural)]):
        lines += [f"[id: p{i}]", f"gt: {' '.join(gt)}",
                  f"pred: {' '.join(pred)}",
                  f"greedy{'(error)' if i == 3 else ''}: {' '.join(greedy)}"]
    dump.write_text("\n".join(lines) + "\n")
    with h5py.File(str(dump).replace(".txt", ".hdf5"), "w") as f:
        for i in range(4):
            grp = f.create_group(f"p{i}")
            grp["greedy_is_correct_execution"] = np.array([i != 0, True])
            grp["program_is_correct_execution"] = np.array([True, i == 2])
    for decode in ("greedy", "pred"):
        argv = ["--dump", str(dump), "--decode", decode]
        with contextlib.redirect_stdout(io.StringIO()):
            got, want = doom_error_analysis.main(argv), jax_doom_errors.main(
                argv)
        assert got == want
        assert "seen_exec_or_species_only" in got
