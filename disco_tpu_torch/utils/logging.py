"""Leveled logging + phase timing (the `clock` and `log` of
disco_tpu/utils/logging.py).

`clock` is the reference's CLOCKSTART/CLOCKSTOP wall-time + RSS-delta
telemetry (src/BuildGraph/src/Common.h:71-95).  It logs at INFO with the
arguments (name, seconds, rss_before_mb, rss_after_mb), so a handler can
collect per-stage walls from the records."""
import logging
import os
import resource
import time
from contextlib import contextmanager

log = logging.getLogger("disco_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("DISCO_TPU_TORCH_LOG", "WARNING").upper())


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


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
