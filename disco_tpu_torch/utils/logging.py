"""Leveled logging, phase timing and the program's span recorder (the
`clock`, `log`, `set_level` and `malloc_trim` of
disco_tpu/utils/logging.py, and `span`, `count`, `job` and `RECORDER`).

The levels are the reference's logcpp names, ERROR..DEBUG4
(src/SimplifyGraph/src/logcpp/log.h), set by `set_level` or the
DISCO_TPU_TORCH_LOG variable.  `clock` is the reference's
CLOCKSTART/CLOCKSTOP wall-time + RSS telemetry
(src/BuildGraph/src/Common.h:71-95, src/SimplifyGraph/src/Config.h:129-134).
It logs at INFO with the arguments (name, seconds, rss_before_mb,
rss_after_mb), so a handler can collect per-stage walls from the records.

Every `clock` is also a span of the recorder, which is always on.  A span
has a name, a start and an end on `time.perf_counter_ns()`, its parent
span and its job.  `cli.main` opens one job a call (`job`); spans and
counters outside any job go to the process's job (id 0).  `span` is a
span without a log line, for steps below a stage; `count` adds to the
current job's counters.  A job keeps one anchor pair (`time.time_ns()`,
`perf_counter_ns()`) taken together when it opens, to place its spans on
the wall clock.  The recorder keeps every span of the last KEEP_SPANS
jobs (the process's job its last PROCESS_SPANS spans), and for the last
KEEP_JOBS jobs their totals by name (count, seconds, self seconds: the
span less its children) and counters.  It never synchronises with or
reads from the card, and enters nothing into a profiler.

A job that spans processes (`buildg -n N -procs`, dist/multiproc.py)
takes its peers' records in once, `join_ranks`: its view then holds
`ranks`, each rank's totals and counters in rank order, and its counters
are their sum; its totals stay this process's."""
import collections
import ctypes
import itertools
import logging
import os
import threading
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

_PAGE = os.sysconf("SC_PAGE_SIZE")

# what the recorder keeps: every span of the last KEEP_SPANS jobs, the
# totals and counters of the last KEEP_JOBS, the last PROCESS_SPANS spans
# outside any job
KEEP_SPANS, KEEP_JOBS, PROCESS_SPANS = 2, 1024, 4096


def set_level(name: str) -> None:
    log.setLevel(LEVELS.get(name.upper(), logging.INFO))


def _rss_mb() -> float:
    """The process's resident set now, in MB (/proc/self/statm), not its
    high-water mark."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * _PAGE / 1048576.0


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


class _Job:
    """One job's record: `spans` holds (id, parent, name, t0, t1, rss) of
    each closed span (rss: (start, end) MB for a `clock`, else None),
    None once the job is past the recorder's span window; `totals` maps a
    name to [count, ns, self ns]."""
    __slots__ = ("id", "name", "t0", "t1", "anchor", "spans", "totals",
                 "counters", "ranks")

    def __init__(self, id_, name, spans):
        self.id, self.name = id_, name
        # taken together: the wall clock, then the span clock
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        self.t0, self.t1 = self.anchor[1], None
        self.spans, self.totals, self.counters = spans, {}, {}
        self.ranks = None

    def own(self) -> dict:
        """This process's totals and counters."""
        return {"totals": {n: (c, ns / 1e9, s / 1e9)
                           for n, (c, ns, s) in self.totals.items()},
                "counters": dict(self.counters)}

    def view(self) -> dict:
        out = {"id": self.id, "name": self.name, "t0": self.t0,
               "t1": self.t1, "anchor": self.anchor, **self.own()}
        if self.ranks is not None:
            rank, views = self.ranks
            ranks = [dict(v, rank=r) for r, v in enumerate(views)]
            ranks[rank].update(self.own())
            counters = {}
            for v in ranks:
                for k, x in v["counters"].items():
                    counters[k] = counters.get(k, 0) + x
            out.update(counters=counters, ranks=ranks)
        return out


class _Span:
    """A span in the making: opened by `with`, recorded when it closes.
    After the block, `seconds` is its length, and with `rss` the resident
    set in MB before it started and after it ended."""
    __slots__ = ("_rec", "name", "id", "parent", "job", "t0", "child",
                 "seconds", "rss")

    def __init__(self, rec, name, rss=False):
        self._rec, self.name, self.rss = rec, name, rss

    def __enter__(self):
        rec = self._rec
        if self.rss:
            self.rss = (_rss_mb(),)
        stack = rec._local.stack
        if stack:
            top = stack[-1]
            self.parent, self.job = top.id, top.job
        else:
            self.job = rec._open or rec._process
            self.parent = self.job.id or None
        self.id = next(rec._ids)
        self.child = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rss:
            self.rss = (self.rss[0], _rss_mb())
        self._rec._close(self, t1)
        return False


class _Local(threading.local):
    def __init__(self):
        self.stack = []       # the thread's open spans, innermost last


class Recorder:
    """Spans and counters by job, in memory, bounded (see the module's
    docstring).  The program records into RECORDER; a test may make its
    own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = _Local()
        self._ids = itertools.count(1)
        self._process = _Job(0, "process",
                             collections.deque(maxlen=PROCESS_SPANS))
        self._jobs = collections.OrderedDict()   # id -> _Job, oldest first
        self._open = None

    def _close(self, sp: _Span, t1: int) -> None:
        # the program records from one thread; the lock guards the job
        # list and the readers, not each span
        stack = self._local.stack
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:          # closed out of order (an abandoned
            stack.remove(sp)       # generator's span, say)
        ns = t1 - sp.t0
        sp.seconds = ns / 1e9
        if stack:
            stack[-1].child += ns
        job = sp.job
        tot = job.totals.get(sp.name)
        if tot is None:
            job.totals[sp.name] = [1, ns, ns - sp.child]
        else:
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - sp.child
        spans = job.spans
        if spans is not None:
            spans.append((sp.id, sp.parent, sp.name, sp.t0, t1,
                          sp.rss or None))

    def span(self, name: str) -> _Span:
        """A span named `name` around a `with` block."""
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the current job's counter `name`."""
        stack = self._local.stack
        job = stack[-1].job if stack else (self._open or self._process)
        job.counters[name] = job.counters.get(name, 0) + n

    @contextmanager
    def job(self, name: str = "job"):
        """A job: its root span `name`, and every span and counter under it
        shares its id.  Inside an open job this is a span of that job."""
        if self._open is not None:
            with self.span(name) as sp:
                yield sp
            return
        with self._lock:
            sp = _Span(self, name)
            sp.id = next(self._ids)
            job = _Job(sp.id, name, [])
            self._jobs[job.id] = job
            while len(self._jobs) > KEEP_JOBS:
                self._jobs.popitem(last=False)
            if len(self._jobs) > KEEP_SPANS:
                for old in itertools.islice(
                        reversed(self._jobs.values()), KEEP_SPANS, None):
                    if old.spans is None:
                        break
                    old.spans = None
            self._open = job
        sp.job, sp.parent, sp.child, sp.t0 = job, None, 0, job.t0
        sp.rss = None
        self._local.stack.append(sp)
        try:
            yield sp
        finally:
            t1 = time.perf_counter_ns()
            self._close(sp, t1)
            job.t1 = t1
            self._open = None

    def snapshot(self) -> dict:
        """{totals, counters} of the current job so far, this process's
        alone: what a rank sends to rank 0."""
        with self._lock:
            return (self._open or self._process).own()

    def join_ranks(self, views, rank: int = 0) -> None:
        """The current job spans processes: `views`, every rank's
        `snapshot` in rank order (each may carry more keys), this one's at
        `rank`, whose entry the job's live record replaces."""
        with self._lock:
            (self._open or self._process).ranks = (rank, list(views))

    def current_job(self) -> int:
        """The id of the open job, 0 outside any."""
        return (self._open or self._process).id

    def jobs(self) -> list:
        """The jobs kept, oldest first, each {id, name, t0, t1 (ns on
        perf_counter; t1 None while open), anchor (wall ns, perf ns),
        totals {name: (count, seconds, self seconds)}, counters}; a job
        that spans processes also {ranks: [{rank, totals, counters, ...}]},
        its counters the ranks' sum."""
        with self._lock:
            return [j.view() for j in self._jobs.values()]

    def spans(self, job_id: int):
        """The spans of job `job_id` (0: the process's), each {id, parent,
        name, t0, t1 (ns on perf_counter), rss}, in the order they closed;
        None when the job's spans are no longer kept."""
        with self._lock:
            job = (self._process if job_id == 0
                   else self._jobs.get(job_id))
            if job is None or job.spans is None:
                return None
            rows = list(job.spans)
        return [dict(zip(("id", "parent", "name", "t0", "t1", "rss"), r))
                for r in rows]

    def totals(self) -> dict:
        """{name: (count, seconds, self seconds)} of the current job."""
        with self._lock:
            return (self._open or self._process).view()["totals"]


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
job = RECORDER.job


@contextmanager
def clock(name: str):
    """A span that logs: its wall seconds and the resident set at its start
    and end."""
    sp = _Span(RECORDER, name, rss=True)
    log.debug(">>> %s()", name)
    try:
        with sp:
            yield
    finally:
        log.info("<<< %s(): %.3fs, rss %.0f -> %.0f MB", name, sp.seconds,
                 *sp.rss)
