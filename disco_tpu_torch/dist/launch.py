"""The launcher of `-procs`' ranks (dist/multiproc.py::Ranks): a server
process that imports torch and the distributed build once and forks a
fresh process for each rank of each job.

Under `mpirun` a rank of Disco's C++ build starts in milliseconds; a
Python rank pays its imports, some 8 s for torch on the card's machine,
and a job would pay them again.  A rank forked from the server starts
without them.  The server never touches CUDA, so each rank makes its own
CUDA context and joins a group formed for its job, as a fresh process
does.

The server is single-threaded, since a fork copies only the forking
thread.  It reads one request a line on its standard input, a JSON object
{argv, log, env, path, cwd}; forks a rank, which takes `path` as its
sys.path and `cwd` as its directory and runs
`multiproc.rank_process(argv, log, env)`; answers {"pid"}; and
reports {"pid", "code"} for each rank it reaps, as JSON lines on its
standard output (the ranks' own output goes to their `log` files).  It
kills its ranks and leaves when its input closes.  `launcher()` starts it
(`python -m disco_tpu_torch.dist.launch`) at the first job of a process and
keeps it for the next; the process that started it closes it at its exit
and waits for it to leave, so that no process outlives the caller."""
import atexit
import json
import os
import queue
import select
import signal
import subprocess
import sys
import threading
import time

POLL_S = 0.02
_LAUNCHER = None


def _say(out: int, msg: dict) -> None:
    os.write(out, json.dumps(msg).encode() + b"\n")


def serve(inp: int = 0) -> None:
    """The server's loop (see the module's docstring).  Its answers go to
    the standard output it was started with; what else writes there goes
    to its standard error."""
    out = os.dup(1)
    os.dup2(2, 1)
    import torch  # noqa: F401  (imported here once, for every rank)

    from . import multiproc
    buf, ranks = b"", set()
    while True:
        if select.select([inp], [], [], POLL_S)[0]:
            chunk = os.read(inp, 1 << 16)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                req = json.loads(line)
                pid = os.fork()
                if pid == 0:
                    try:
                        null = os.open(os.devnull, os.O_RDONLY)
                        os.dup2(null, inp)
                        os.close(null)
                        os.close(out)
                        sys.path[:] = req["path"]
                        os.chdir(req["cwd"])
                        multiproc.rank_process(req["argv"], req["log"],
                                               req["env"])
                    finally:
                        os._exit(1)
                ranks.add(pid)
                _say(out, {"pid": pid})
        while ranks:
            pid, status = os.waitpid(-1, os.WNOHANG)
            if pid == 0:
                break
            ranks.discard(pid)
            _say(out, {"pid": pid, "code": os.waitstatus_to_exitcode(status)})
    for pid in ranks:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)


class Rank:
    """A rank the server forked: its `pid`, `exitcode` (None while it
    runs; negative: the signal that ended it), `kill`, `join`."""

    def __init__(self, launcher, pid: int):
        self._launcher, self.pid = launcher, pid

    @property
    def exitcode(self):
        return self._launcher.codes.get(self.pid)

    def kill(self) -> None:
        if self.exitcode is None:
            try:
                os.kill(self.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    def join(self, timeout: float = None) -> None:
        """Until the server has reaped the rank, or `timeout` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.exitcode is None and self._launcher.alive() and (
                deadline is None or time.monotonic() < deadline):
            time.sleep(POLL_S)


class Launcher:
    """This process's handle on a server: `start` forks a rank."""

    def __init__(self, env: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "disco_tpu_torch.dist.launch"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self.codes, self._pids = {}, queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        atexit.register(self.close)

    def close(self, timeout: float = 10.0) -> None:
        """End the server: its input closed, it kills its ranks and leaves;
        killed if it has not left after `timeout` seconds."""
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def _read(self):
        for line in self.proc.stdout:
            msg = json.loads(line)
            if "code" in msg:
                self.codes[msg["pid"]] = msg["code"]
            else:
                self._pids.put(msg["pid"])
        self._pids.put(None)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def start(self, argv, log_path: str, env: dict, timeout: float) -> Rank:
        """Fork a rank running `multiproc.rank_process(argv, log_path,
        env)` with this process's sys.path and directory; raises
        RuntimeError when the server does not answer within `timeout`
        seconds."""
        req = {"argv": list(argv), "log": log_path, "env": env,
               "path": list(sys.path), "cwd": os.getcwd()}
        self.proc.stdin.write(json.dumps(req).encode() + b"\n")
        self.proc.stdin.flush()
        try:
            pid = self._pids.get(timeout=timeout)
        except queue.Empty:
            pid = None
        if pid is None:
            raise RuntimeError("the rank launcher did not start a rank")
        return Rank(self, pid)


def launcher(env: dict) -> Launcher:
    """This process's launcher, started (with `env`) at its first use or
    when the last one has ended."""
    global _LAUNCHER
    if _LAUNCHER is None or not _LAUNCHER.alive():
        _LAUNCHER = Launcher(env)
    return _LAUNCHER


if __name__ == "__main__":
    serve()
    # its ranks are reaped: leave without the interpreter's teardown of
    # torch, which the caller would wait for
    sys.stderr.flush()
    os._exit(0)
