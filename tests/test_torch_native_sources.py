"""disco_tpu_torch keeps its own copies of the C++ host sources it builds
(native/src/{readqc,overlap,replay}.cpp): they stay byte-identical to
disco_tpu/native's, and neither the port nor chip_smoke.py reads, builds or
loads a file under disco_tpu/."""
import json
import pathlib
import subprocess
import sys

import pytest

from disco_tpu_torch import kernels
from disco_tpu_torch import native

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "disco_tpu"
SOURCES = ("readqc", "overlap", "replay")


def _under_jax_package(path) -> bool:
    p = pathlib.Path(path)
    p = (p if p.is_absolute() else ROOT / p).resolve()
    return p == JAX_PKG or JAX_PKG in p.parents


@pytest.mark.parametrize("name", SOURCES)
def test_cpp_copy_is_byte_identical(name):
    copy = kernels.NATIVE_SRC / f"{name}.cpp"
    assert not copy.is_symlink()
    assert copy.read_bytes() == (JAX_PKG / "native" / f"{name}.cpp"
                                 ).read_bytes()


def test_load_native_builds_the_ports_copies(monkeypatch):
    """The g++ command line `load_native` would run, for every host library
    of the port: sources under disco_tpu_torch/native/src, output in the
    port's build directory, no argument under disco_tpu/."""
    assert kernels.NATIVE_SRC == kernels.PKG_DIR / "native" / "src"
    assert not _under_jax_package(kernels.NATIVE_SRC)
    seen = {}

    def fake_build(out, sources, cmd, deps=()):
        seen[pathlib.Path(out).name] = (out, list(sources), list(cmd))
        raise _Stop

    monkeypatch.setattr(kernels, "_build", fake_build)
    monkeypatch.setattr(native, "_LIBS", {})
    for name in native._SPECS:
        with pytest.raises(_Stop):
            native._lib(name)
    assert sorted(seen) == sorted(f"_{n}.so" for n in SOURCES)
    for out, sources, cmd in seen.values():
        assert pathlib.Path(out).parent == kernels.BUILD_DIR
        assert [pathlib.Path(s).parent for s in sources] == [
            kernels.NATIVE_SRC]
        assert all(pathlib.Path(s).exists() for s in sources)
        assert cmd[0] == "g++"
        assert not any(_under_jax_package(x)
                       for x in [out, *sources, *cmd[1:]])


class _Stop(Exception):
    pass


# Imports every module of the port and chip_smoke.py, then builds and loads
# the host libraries into a fresh directory, recording every file opened,
# listed or loaded and every command started (Python audit events).
_AUDIT = """
import importlib, json, os, pathlib, sys, tempfile
seen = []
def hook(event, args):
    if event in ("open", "os.listdir", "os.scandir", "ctypes.dlopen"):
        if args and isinstance(args[0], (str, bytes, os.PathLike)):
            seen.append(os.fsdecode(args[0]))
    elif event == "subprocess.Popen":
        seen.extend(os.fsdecode(a) for a in args[1] if isinstance(
            a, (str, bytes, os.PathLike)))
sys.addaudithook(hook)
for m in MODULES:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
from disco_tpu_torch import kernels, native
with tempfile.TemporaryDirectory() as d:
    kernels.BUILD_DIR = pathlib.Path(d)
    native.build_all()
    built = sorted(p.name for p in pathlib.Path(d).iterdir())
print(json.dumps({"seen": seen, "built": built}))
"""


def test_port_reads_nothing_of_the_jax_package():
    from test_torch_imports import _modules

    code = _AUDIT.replace("MODULES", repr(_modules()))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["built"] == sorted(f"_{n}.so" for n in SOURCES)
    assert any(str(kernels.NATIVE_SRC) in s for s in out["seen"])
    bad = sorted({s for s in out["seen"] if _under_jax_package(s)})
    assert not bad, bad
