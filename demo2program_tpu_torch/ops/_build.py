"""Build the port's hand-written CUDA kernels with nvcc.

Each library is compiled from the sources under `demo2program_tpu_torch/csrc/`
at first use into `build/kernels/` at the root of the checkout, as a shared
library with a plain C interface, which the wrapper loads with ctypes.
The file name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is reused. The compiler's output (with
ptxas's register, shared-memory and spill report) is kept beside it.

Nothing here runs at import: the CPU test host has no nvcc.
"""

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build(name, sources):
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so.

    Returns (path, seconds spent compiling, compiler output). A library
    that already exists is reused: 0 seconds and the output it was built
    with."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds, log
