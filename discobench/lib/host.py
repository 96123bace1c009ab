"""Host-side readings: a frozen copy of disco_tpu_torch/tools/bench_e2e.py's
`RssPeak` and `StageWalls`.  StageWalls also keeps when each stage ended
(the record's wall-clock time), so that the idle gaps of a traced job can
be put to the host stage that was running.  `settle` runs between the
window's jobs."""
import ctypes
import gc
import logging
import os
import threading


class RssPeak:
    """While open, a thread reads this process's resident set from
    /proc/self/statm every `period` seconds and keeps the largest (the
    kernel's own peak, VmHWM, cannot be reset on every host)."""

    def __init__(self, period: float = 0.01):
        self.period = period
        self.start = self.peak = 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _sample(self) -> int:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * self._page
        self.peak = max(self.peak, rss)
        return rss

    def _run(self):
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self):
        self.start = self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            raise RuntimeError("the RSS sampler did not stop")
        self._sample()


class StageWalls(logging.Handler):
    """Collects the (stage, seconds, wall-clock end) records of the
    program's `clock` stages (`<<< name(): secs` at INFO, with the name and
    the seconds as the record's first two arguments)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.walls = []

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("<<<"):
            self.walls.append((record.args[0], float(record.args[1]),
                               record.created))


def settle():
    """Give back what the last job freed before the next one starts, as a
    fresh process would have it: objects held in reference cycles, and the
    free pages glibc keeps in its heap."""
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
