"""demo2program_tpu_torch imports with jax, flax, optax, orbax, h5py, cv2
and the JAX package demo2program_tpu blocked, and no module of it imports
jax, cv2 or the JAX package (the GPU machine has no cv2: frames are shrunk
by utils/area_resize.py)."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "demo2program_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "cv2",
           "demo2program_tpu")

_PROBE = f"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import demo2program_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("tools.eval_execution", "tools.inspect_output", "native",
             "data.karel_generator", "data.merge_datasets", "data.pipeline",
             "cli.generator_cli", "tools.visualize_data", "utils.png",
             "parallel", "parallel.mesh", "tools.hit_analysis",
             "tools.measure_program_fix_accuracy",
             "tools.doom_error_analysis", "cli.recipe_cli"):
    assert "demo2program_tpu_torch." + name in names, name
# nothing builds at import, and no process group forms
assert sys.modules["demo2program_tpu_torch.native"]._lib is None
import torch.distributed
assert not torch.distributed.is_initialized()
print(len(names))
"""


def test_package_imports_with_jax_and_h5py_blocked():
    """The top-level name is compared, so demo2program_tpu_torch itself is
    not blocked by the entry demo2program_tpu."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 60  # every submodule was walked


def test_no_module_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|cv2)\b"
                         r"|^\s*(import|from)\s+demo2program_tpu\b(?!_torch)",
                         re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += ["chip_smoke.py"] if pattern.search(
        (ROOT / "chip_smoke.py").read_text()) else []
    assert not offenders, offenders


def test_h5py_is_imported_only_where_a_file_is_opened():
    """No module of the port imports h5py at its top level: every import of
    it is indented, inside the function that opens a file."""
    pattern = re.compile(r"^(import|from)\s+h5py\b", re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
    assert any(re.search(r"^\s+import h5py", p.read_text(), re.MULTILINE)
               for p in (PACKAGE / "tools").glob("*.py"))
