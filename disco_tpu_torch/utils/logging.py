"""Leveled logging + phase timing (the `clock`, `log`, `set_level` and
`malloc_trim` of disco_tpu/utils/logging.py).

The levels are the reference's logcpp names, ERROR..DEBUG4
(src/SimplifyGraph/src/logcpp/log.h), set by `set_level` or the
DISCO_TPU_TORCH_LOG variable.  `clock` is the reference's
CLOCKSTART/CLOCKSTOP wall-time + RSS-delta telemetry
(src/BuildGraph/src/Common.h:71-95, src/SimplifyGraph/src/Config.h:129-134).
It logs at INFO with the arguments (name, seconds, rss_before_mb,
rss_after_mb), so a handler can collect per-stage walls from the records."""
import ctypes
import logging
import os
import resource
import time
from contextlib import contextmanager

LEVELS = {"ERROR": logging.ERROR, "WARNING": logging.WARNING,
          "INFO": logging.INFO, "DEBUG": logging.DEBUG,
          "DEBUG1": logging.DEBUG, "DEBUG2": logging.DEBUG,
          "DEBUG3": logging.DEBUG, "DEBUG4": logging.DEBUG}

log = logging.getLogger("disco_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(LEVELS.get(
        os.environ.get("DISCO_TPU_TORCH_LOG", "WARNING").upper(),
        logging.WARNING))


def set_level(name: str) -> None:
    log.setLevel(LEVELS.get(name.upper(), logging.INFO))


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def malloc_trim() -> None:
    """Return freed glibc heap pages to the OS.  The native phases (the
    in-process parsimplify arena, relation buffers) leave freed heap
    behind; without the trim the next phase's allocations stack on top of
    it and raise the peak RSS (the reference runs parsimplify as a process
    of its own, so its peak never stacks)."""
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


@contextmanager
def clock(name: str):
    """Wall seconds + RSS delta of the enclosed stage."""
    t0 = time.perf_counter()
    m0 = _rss_mb()
    log.debug(">>> %s()", name)
    try:
        yield
    finally:
        log.info("<<< %s(): %.3fs, rss %.0f -> %.0f MB", name,
                 time.perf_counter() - t0, m0, _rss_mb())
