"""ctypes bindings for the native batch Karel engine (csrc/karel_engine.cpp).

Port of demo2program_tpu/native.py with its own copy of the C++ source. The
shared library is compiled with g++ at first use into `build/native/` at the
root of the checkout, as `libkarel-<hash>.so`: the hash covers the source
and the flags, so an edited source builds anew and an unchanged one is
reused. The compiler's output is kept beside it (`.log`). Nothing builds at
import.

`available()` reports whether the library builds and loads (the
generator's `auto` backend asks it); `run_batch` raises when it does not,
naming the compiler's error. `run_batch` executes bytecode from
dsl/karel_bytecode.py with the instruction semantics of the host
interpreter and of the device VM.
"""

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "karel_engine.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_load_error = None


def build():
    """Compile the engine unless a library of this source exists -> (path,
    seconds spent compiling, compiler output). Raises RuntimeError when g++
    fails or is missing."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libkarel-{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds, log


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.karel_run_batch.restype = ctypes.c_int
        lib.karel_run_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
        ]
        _lib = lib
    except (RuntimeError, OSError) as e:  # no g++, a failed build or load
        _load_error = e
    return _lib


def available():
    return _load() is not None


def run_batch(bytecode, walls, markers0, agent0, prog_idx,
              make_error=True, max_record=32):
    """Execute a batch of rollouts.

    bytecode: (n_progs, L, 2) int32; walls: (n, h, w) bool;
    markers0: (n, h, w) int; agent0: (n, 3) int (y, x, d);
    prog_idx: (n,) int mapping rollout -> program.

    Returns dict(success (n,), length (n,), n (n,), actions (n, max_record-1),
    agent (n, max_record, 3), markers (n, max_record, h, w)).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_load_error}")
    bytecode = np.ascontiguousarray(bytecode, np.int32)
    walls = np.ascontiguousarray(walls, np.uint8)
    markers0 = np.ascontiguousarray(markers0, np.int8)
    agent0 = np.ascontiguousarray(agent0, np.int32)
    prog_idx = np.ascontiguousarray(prog_idx, np.int32)
    n_progs, code_len = bytecode.shape[0], bytecode.shape[1]
    n, h, w = walls.shape

    success = np.zeros(n, np.uint8)
    length = np.zeros(n, np.int32)
    n_budget = np.zeros(n, np.int32)
    actions = np.zeros((n, max_record - 1), np.int8)
    agent = np.zeros((n, max_record, 3), np.int32)
    markers = np.zeros((n, max_record, h, w), np.int8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.karel_run_batch(
        ptr(bytecode, ctypes.c_int32), n_progs, code_len,
        ptr(walls, ctypes.c_uint8), ptr(markers0, ctypes.c_int8),
        ptr(agent0, ctypes.c_int32), ptr(prog_idx, ctypes.c_int32),
        n, h, w, int(make_error), max_record,
        ptr(success, ctypes.c_uint8), ptr(length, ctypes.c_int32),
        ptr(n_budget, ctypes.c_int32), ptr(actions, ctypes.c_int8),
        ptr(agent, ctypes.c_int32), ptr(markers, ctypes.c_int8))
    if rc != 0:
        raise RuntimeError(f"karel_run_batch failed with rc={rc}")
    return {"success": success.astype(bool), "length": length,
            "n": n_budget, "actions": actions, "agent": agent,
            "markers": markers}
