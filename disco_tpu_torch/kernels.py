"""Build and load the port's compiled code at first use.

Two kinds of shared library, both with a plain C interface loaded through
ctypes, both built into BUILD_DIR (listed in .gitignore):

- the CUDA kernels in ``csrc/*.cu``, compiled by ``nvcc`` for sm_90a
  (H100).  A plain C interface compiles in seconds; a source that includes
  PyTorch's headers would take minutes;
- the C++ host sources in ``native/src/*.cpp``, compiled by ``g++``.  They
  are byte-identical copies of their counterparts in the JAX package
  (``tests/test_torch_native_sources.py`` holds them so); the port builds
  and reads nothing outside its own directory;
- the port's own C++ host sources in ``native/port/*.cpp`` (no twin in the
  JAX package; the tests hold them to ``native/src``'s), also by ``g++``.

A library is rebuilt when it is missing or older than one of its sources
or of the headers they include (`deps`).  Each build writes a private temporary file and renames it into place, so
processes that build the same library at once do not see half a file.
A compile is the span `kernels.build`, a load `kernels.load`
(utils/logging.py)."""
import ctypes
import os
import pathlib
import shutil
import subprocess

from .utils.logging import span

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
NATIVE_SRC = PKG_DIR / "native" / "src"
PORT_SRC = PKG_DIR / "native" / "port"
BUILD_DIR = PKG_DIR / "_build"

CUDA_ARCH = "-gencode=arch=compute_90a,code=sm_90a"


def _build(out: pathlib.Path, sources, cmd, deps=()) -> pathlib.Path:
    """Run `cmd -o out sources` unless `out` is newer than every source and
    every dep (a header the sources include; not passed to `cmd`)."""
    srcs = [pathlib.Path(s) for s in sources]
    inputs = srcs + [pathlib.Path(d) for d in deps]
    for s in inputs:
        if not s.exists():
            raise FileNotFoundError(f"source {s} not found")
    if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime
                            for s in inputs):
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    with span("kernels.build"):
        subprocess.run([*cmd, "-o", str(tmp), *map(str, srcs)], check=True)
        os.replace(tmp, out)
    return out


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install path."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def load_cuda(name: str, deps=()) -> ctypes.CDLL:
    """Compile csrc/<name>.cu for sm_90a (once) and load it.  `deps` names
    the csrc/ headers it includes: a newer header rebuilds the library."""
    so = _build(BUILD_DIR / f"lib{name}.so", [CSRC / f"{name}.cu"],
                [nvcc(), CUDA_ARCH, "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC"], deps=[CSRC / d for d in deps])
    with span("kernels.load"):
        return ctypes.CDLL(str(so))


def _load_cpp(src: pathlib.Path, out: str, opt: str, extra) -> ctypes.CDLL:
    so = _build(BUILD_DIR / out, [src],
                ["g++", opt, "-shared", "-fPIC", "-std=c++17", *extra])
    with span("kernels.load"):
        return ctypes.CDLL(str(so))


def load_native(name: str, opt: str = "-O2", extra=()) -> ctypes.CDLL:
    """Compile native/src/<name>.cpp with g++ (once) and load it."""
    return _load_cpp(NATIVE_SRC / f"{name}.cpp", f"_{name}.so", opt, extra)


def load_port_native(name: str, opt: str = "-O3", extra=()) -> ctypes.CDLL:
    """Compile native/port/<name>.cpp with g++ (once) and load it."""
    return _load_cpp(PORT_SRC / f"{name}.cpp", f"_port_{name}.so", opt,
                     extra)
