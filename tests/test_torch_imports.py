"""The torch port imports with JAX blocked and never imports provekit_tpu."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "provekit_tpu_torch"

_CHILD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import provekit_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    provekit_tpu_torch.__path__, "provekit_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "provekit_tpu" or m.startswith("provekit_tpu.")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # 83 since native/build.py and native/encode.py
    assert int(out.stdout.strip()) >= 83


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|provekit_tpu)\b", re.M)
    files = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert not offenders, offenders


def test_port_sources_name_no_jax_native_library():
    """The port builds its own host libraries (``native/curve.cpp`` and
    ``native/solver.cpp`` over ``native/field256.hpp``) into ``build/``: no
    source of it names the JAX package's libraries or native directory."""
    pat = re.compile(r"libpkcurve\.so|libpknative\.so|provekit_tpu/native|"
                     r"parents?\W*(\[\d\]|(\.parent)+)\s*/\s*\"native\"")
    files = [*PORT.rglob("*.py"), *PORT.rglob("*.cpp"),
             *PORT.rglob("*.hpp"), ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert not offenders, offenders
    assert not pat.search('_DIR = Path(__file__).resolve().parent / "x"')
    assert pat.search('Path(__file__).resolve().parents[2] / "native"')
    assert pat.search('_LIB_PATH = _NATIVE_DIR / "libpknative.so"')
    assert pat.search('Path(__file__).resolve().parent.parent.parent / '
                      '"native"')


def test_kernel_signatures_match_sources():
    """Every csrc/*.cu is built, and each C entry point named for it is
    defined there with the argument count ``kernels.SIGNATURES`` gives
    (ctypes would pass a wrong count on silently)."""
    from provekit_tpu_torch import kernels as K
    sources = sorted(p.name for p in K.CSRC.glob("*.cu"))
    assert sorted(K.SIGNATURES) == sources
    for src, sigs in K.SIGNATURES.items():
        text = (K.CSRC / src).read_text()
        for name, argtypes in sigs.items():
            m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
            assert m, (src, name)
            params = m.group(1).strip()
            count = params.count(",") + 1 if params else 0
            assert count == len(argtypes), (src, name)
