"""The port's native Karel engine (demo2program_tpu_torch/native.py, its own
copy of the C++ source) against the JAX package's: the same outputs of
`run_batch` on random programs and states, with and without make_error;
the library is built under build/native/ and the JAX package's
native/libkarel.so is never written; a failed build raises."""

import os
from pathlib import Path

import numpy as np
import pytest

from demo2program_tpu import native as jax_native
from demo2program_tpu_torch import native
from demo2program_tpu_torch.data import karel_generator
from demo2program_tpu_torch.dsl import karel_parser
from demo2program_tpu_torch.dsl.karel_bytecode import (
    BytecodeTooLong, compile_ast)
from demo2program_tpu_torch.dsl.karel_sampler import KarelProgramSampler
from demo2program_tpu_torch.envs.karel import KarelStateGenerator

ROOT = Path(__file__).resolve().parents[1]



@pytest.fixture(autouse=True)
def _toolchain():
    """Both engines build with g++ at first use; decided per test, not at
    import, so every worker collects the same tests."""
    if not jax_native.available():
        pytest.skip("no C++ toolchain for the engine")


def _random_batch(seed, n_programs=48, per_program=4):
    """Sampled programs' bytecode and random initial states, several
    rollouts a program."""
    sampler = KarelProgramSampler(seed=seed)
    codes = []
    while len(codes) < n_programs:
        ast, ok = karel_parser.parse(sampler.random_code())
        try:
            codes.append(compile_ast(ast))
        except BytecodeTooLong:
            continue
    n = n_programs * per_program
    walls, markers0, agent0 = KarelStateGenerator(seed=seed).generate_batch(
        n, 8, 8, 0.1)
    prog_idx = np.repeat(np.arange(n_programs), per_program)
    return np.stack(codes), walls, markers0, agent0, prog_idx


@pytest.mark.parametrize("make_error", [True, False])
def test_run_batch_matches_jax(make_error):
    args = _random_batch(seed=17 if make_error else 18)
    want = jax_native.run_batch(*args, make_error=make_error, max_record=32)
    got = native.run_batch(*args, make_error=make_error, max_record=32)
    assert set(got) == set(want)
    assert want["success"].any() and not want["success"].all()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_builds_under_build_native_and_never_writes_libkarel(tmp_path,
                                                            monkeypatch):
    """The default library lives under build/native/ with its hash in the
    name and the compiler's log beside it; a fresh build (into a temporary
    build dir) makes only those two files; native/libkarel.so keeps its
    mtime throughout."""
    jax_lib = ROOT / "native" / "libkarel.so"
    jax_native.available()  # the JAX package builds its own, if it must
    before = os.stat(jax_lib).st_mtime_ns
    path, _, _ = native.build()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libkarel-") and path.suffix == ".so"
    assert path.with_suffix(".log").exists()

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    fresh, seconds, _ = native.build()
    assert seconds > 0 and fresh.name == path.name
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])
    again, seconds, _ = native.build()
    assert again == fresh and seconds == 0.0
    assert os.stat(jax_lib).st_mtime_ns == before


def test_failed_build_raises_and_auto_falls_back(tmp_path, monkeypatch):
    """A source g++ refuses: build() raises with the compiler's words,
    available() is False, backend 'native' raises before any program is
    drawn, and 'auto' takes python."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        karel_generator.resolve_backend("native")
    assert karel_generator.resolve_backend("auto") is False
    assert not list((tmp_path / "native").glob("*.so"))
