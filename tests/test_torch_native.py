"""The port's tests build disco_tpu's native libraries in a directory of
their own process.

disco_tpu/native/__init__.py compiles each C++ library in place (`g++ -o
_<name>.so` into the package directory), so under several test workers one
process can load a library that another is still writing ("file too
short").  `private_native` copies the C++ sources into a temporary
directory and points `disco_tpu.native._DIR` there for the module that uses
it: the module's builds go there, and nothing is written into
disco_tpu/native/.  A library this process has already loaded stays loaded.

Every tests/test_torch_*.py module that reaches disco_tpu.native imports
the fixture, which is autouse:

    from test_torch_native import private_native  # noqa: F401
"""
import pathlib
import shutil

import numpy as np
import pytest

import disco_tpu.native as jnative

NATIVE_DIR = pathlib.Path(jnative.__file__).resolve().parent


@pytest.fixture(scope="module", autouse=True)
def private_native(tmp_path_factory):
    """A private copy of disco_tpu/native/*.cpp, where disco_tpu.native
    builds for the rest of the module (the sources include no local
    headers)."""
    d = tmp_path_factory.mktemp("disco_tpu_native")
    for cpp in NATIVE_DIR.glob("*.cpp"):
        shutil.copy2(cpp, d / cpp.name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_DIR", d)
        yield d


def test_readstore_loads_the_private_library(private_native, monkeypatch):
    """A disco_tpu ReadStore load builds and loads _readqc.so in the
    private directory.  `_READQC` is cleared first (and restored after), so
    the load is this test's even when the process loaded the library
    before."""
    from disco_tpu.io.readstore import ReadStore

    monkeypatch.setattr(jnative, "_READQC", None)
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGT"), 120)) for _ in range(4)]
    store = ReadStore.from_sequences(seqs)
    assert store.n_reads == 4
    lib = pathlib.Path(jnative._READQC._name)
    assert lib.parent == private_native
    assert lib.name == "_readqc.so" and lib.exists()
    assert sorted(p.name for p in private_native.glob("*.cpp")) == sorted(
        p.name for p in NATIVE_DIR.glob("*.cpp"))


def test_sources_are_copied_not_linked(private_native):
    for cpp in private_native.glob("*.cpp"):
        assert not cpp.is_symlink()
        assert cpp.read_bytes() == (NATIVE_DIR / cpp.name).read_bytes()
