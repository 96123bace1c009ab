"""disco_tpu_torch.kernels' build rule: a library is rebuilt when it is
missing or older than its source or one of the headers the source
includes.  The compiler is a stand-in that records each build."""
import os
import pathlib
import sys

from disco_tpu_torch import kernels

# writes "built <n>" to the file after -o, n counting the builds so far
FAKE_CC = [sys.executable, "-c",
           "import sys, pathlib\n"
           "out = pathlib.Path(sys.argv[sys.argv.index('-o') + 1])\n"
           "log = out.parent / 'builds.log'\n"
           "n = len(log.read_text().splitlines()) if log.exists() else 0\n"
           "log.write_text('x\\n' * (n + 1))\n"
           "out.write_text(f'built {n + 1}')\n"]


def _build(tmp_path, out, src, hdr):
    return kernels._build(out, [src], FAKE_CC, deps=[hdr])


def _set_mtime(path, t):
    os.utime(path, (t, t))


def test_header_newer_than_library_rebuilds(tmp_path):
    src, hdr = tmp_path / "k.cu", tmp_path / "window.cuh"
    src.write_text('#include "window.cuh"\n')
    hdr.write_text("// v1\n")
    out = tmp_path / "build" / "libk.so"
    _set_mtime(src, 1_000_000)
    _set_mtime(hdr, 1_000_000)
    assert _build(tmp_path, out, src, hdr) == out
    assert out.read_text() == "built 1"
    _set_mtime(out, 2_000_000)
    _build(tmp_path, out, src, hdr)              # up to date: no build
    assert out.read_text() == "built 1"
    _set_mtime(hdr, 3_000_000)                   # the header changed
    _build(tmp_path, out, src, hdr)
    assert out.read_text() == "built 2"
    _set_mtime(out, 4_000_000)
    _set_mtime(src, 5_000_000)                   # the source changed
    _build(tmp_path, out, src, hdr)
    assert out.read_text() == "built 3"
    assert not list(out.parent.glob("*.tmp"))


def test_missing_header_raises(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("\n")
    try:
        kernels._build(tmp_path / "libk.so", [src], FAKE_CC,
                       deps=[tmp_path / "gone.cuh"])
    except FileNotFoundError as e:
        assert "gone.cuh" in str(e)
    else:
        raise AssertionError("no error for a missing header")
    assert not (tmp_path / "libk.so").exists()


class _Stop(Exception):
    pass


def test_kernel_loaders_name_their_headers(monkeypatch):
    """Every CUDA source of the port is built with each header it includes
    (window.cuh, tile_ring.cuh, and the headers those include) among its
    deps."""
    import re

    import pytest

    from disco_tpu_torch.overlap import fused_kernel as fk

    seen = {}

    def fake_build(out, sources, cmd, deps=()):
        seen[pathlib.Path(sources[0]).name] = [pathlib.Path(d) for d in deps]
        raise _Stop

    monkeypatch.setattr(kernels, "_build", fake_build)
    from disco_tpu_torch.tools import exp_k1_rows_designs as k1d
    from disco_tpu_torch.tools import exp_k6_designs as kd

    for module, attr, loader in ((fk, "_LIB", fk.load),
                                 (fk, "_WINDOW_LIB", fk.load_window),
                                 (fk, "_STAGED_LIB", fk.load_staged),
                                 (kd, "_LIB", kd.load),
                                 (k1d, "_LIB", k1d.load)):
        monkeypatch.setattr(module, attr, None)
        with pytest.raises(_Stop):
            loader()
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    assert sorted(seen) == sources == ["dual_compare.cu",
                                       "k1_rows_designs.cu",
                                       "k6_designs.cu", "window_compare.cu",
                                       "window_staged.cu"]
    def includes(path):
        return set(re.findall(r'#include "(\w+\.cuh)"', path.read_text()))

    for name, deps in seen.items():
        want, todo = set(), includes(kernels.CSRC / name)
        while todo:
            h = todo.pop()
            want.add(h)
            todo |= includes(kernels.CSRC / h) - want
        assert "window.cuh" in want
        assert want == {d.name for d in deps}, name
        assert all(d.exists() for d in deps)
    assert kernels.CSRC / "tile_ring.cuh" in seen["window_staged.cu"]
