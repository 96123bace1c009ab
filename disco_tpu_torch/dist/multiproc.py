"""One process per rank: the distributed buildG over `torch.distributed`
(the counterpart of disco_tpu/dist/multiproc.py; reference:
runDisco-MPI.sh:214 `mpirun -np N buildG-MPI ...`).

- every rank joins one process group (`init_process_group`, the MPI_Init
  equivalent) and holds a contiguous block of the mesh's shards
  (`mesh.process_mesh`);
- every rank runs the one front end, `builder.run_buildg_sharded`: it
  parses every input and builds the store and the table (the reference's
  replicated parse, reference: src/BuildGraphMPI/src/HashTable.cpp:53),
  computes its shards' slice of each superstep (with -rma holding only its
  shards' slice of the packed payload), gathers every shard's kept rows
  (`builder._pull`) and runs the containment replay; rank 0 alone writes
  the files and runs the graph replay; a barrier ends the build;
- then every rank's span totals and counters go to rank 0's job
  (`gather_ranks`, utils/logging.py's `join_ranks`).

The files are byte-identical to the single-process build's, whatever the
rank count and mode.  Where disco_tpu raises on a cap overflow, every rank
re-runs the chunk exactly (`builder._chunk_fallback`) and gets the same
rows.

Two launches:
- `buildg`/`assemble -n N -procs` (`Ranks`): the calling process is rank 0
  on cuda:0 and starts ranks 1 .. N-1 for the job, one a card, each
  `main` with this launch's arguments in a fresh process, its output to a
  file; the group is formed for the job and torn down after it, as
  `mpirun` does; each rank's host work runs on its share of this host's
  cores (`host_share`), as each of mpirun's ranks has its node's.  The
  ranks are forked from a server process that has imported torch and
  this module once (dist/launch.py), so that a job
  does not pay a rank's imports (some 8 s on the card's machine, where a
  rank of Disco's C++ starts in milliseconds); the server never touches
  CUDA;
- by hand, one process a rank:
  python -m disco_tpu_torch.dist.multiproc --coordinator HOST:PORT \\
      --num-processes N --process-id I -pe reads.fasta -f PREFIX [-rma]
  Under torchrun (`env://`: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) or
  srun / mpirun (`derive_cluster_env`) the rank needs no arguments.
Each rank takes one shard on cuda:(LOCAL_RANK or rank) % cards over NCCL;
`--dist-backend gloo` lets ranks share a card (NCCL refuses two ranks on
one card); `--local-devices L` runs L shards a rank on the CPU over gloo
(testing)."""
import argparse
import contextlib
import ctypes
import datetime
import logging
import os
import pathlib
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..overlap.relation import _default_device
from ..utils.logging import RECORDER, job, log, span
from . import launch
from .builder import run_buildg_sharded, sharded_relation
from .mesh import Mesh, process_mesh

# seconds a collective or the rendezvous waits for a peer before the group
# gives up: the bound on a job whose rank stopped answering
RANK_TIMEOUT_S = 600.0
# seconds the ranks get to leave once rank 0 is done with them (a failed
# job: FAILED_EXIT_S), and how often rank 0 looks at them
EXIT_S, FAILED_EXIT_S, POLL_S = 60.0, 5.0, 0.2
# the launch environment a started rank must not inherit: it names another
# world (torchrun's, a scheduler's)
_WORLD_VARS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
               "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_",
               "OMPI_COMM_WORLD_", "DISCO_TPU_COORDINATOR")
_PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]


def sharded_relation_multiproc(store, table, mesh: Mesh,
                               hit_cap: Optional[int] = None,
                               route_cap: Optional[int] = None,
                               budget: int = 1 << 25,
                               dist_mem: bool = False):
    """disco_tpu's multi-process relation, with its arguments: the
    one-process `sharded_relation` (unpruned) over a mesh that spans the
    processes (`process_mesh`), whose collect gathers every shard's kept
    rows to every rank.  Call it on every rank; every rank returns the same
    relation (its `stats` count chunks and fallback chunks)."""
    return sharded_relation(store, table, mesh, route_cap=route_cap,
                            budget=budget, dist_mem=dist_mem,
                            hit_cap=hit_cap)


def rank_device(rank: Optional[int] = None) -> torch.device:
    """This rank's card: cuda:(LOCAL_RANK or rank) % cards; `rank`
    defaults to the group's."""
    _default_device()          # raises without a card
    if rank is None:
        rank = dist.get_rank()
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def run_buildg_multiproc(paired_files: Sequence[str],
                         single_files: Sequence[str], prefix: str,
                         min_overlap: int = 30,
                         write_par_graph_size: int = 1000,
                         dist_mem: bool = False,
                         mesh: Optional[Mesh] = None):
    """`builder.run_buildg_sharded` across the initialised process group,
    `mesh` by default one shard a rank on its card (`rank_device`)."""
    return run_buildg_sharded(
        paired_files, single_files, prefix,
        mesh or process_mesh(1, rank_device()), min_overlap=min_overlap,
        write_par_graph_size=write_par_graph_size, dist_mem=dist_mem)


def form_group(backend: str, device: torch.device, store=None,
               world: int = -1, rank: int = -1,
               timeout: float = RANK_TIMEOUT_S) -> None:
    """Join the default process group, over `store` (a TCPStore) or from
    torchrun's environment (`env://`) without one, every collective bound
    by `timeout` seconds; then one all_to_all and one all_gather of a few
    bytes, so that the communicator and its links are made here and not in
    the first exchange."""
    limit = datetime.timedelta(seconds=timeout)
    if store is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=limit)
    else:
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank, timeout=limit)
    n = dist.get_world_size()
    x = torch.zeros(n, dtype=torch.int32, device=device)
    dist.all_to_all_single(torch.empty_like(x), x)
    dist.all_gather_into_tensor(x.new_empty(n * n), x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def leave_group(clean: bool = True) -> None:
    """Leave the default process group: destroyed after a clean run,
    aborted (NCCL) after a failure, where a collective may still wait for a
    peer that is gone.  Never raises; the group is gone after it."""
    if not dist.is_initialized():
        return
    try:
        if clean or dist.get_backend() != "nccl":
            dist.destroy_process_group()
        else:
            dist.distributed_c10d._abort_process_group()
    except Exception as e:            # noqa: BLE001 (a failure's cleanup)
        log.warning("leaving the process group: %s", e)
        try:
            if dist.is_initialized():
                dist.distributed_c10d._abort_process_group()
        except Exception as e:        # noqa: BLE001
            log.warning("aborting the process group: %s", e)


def host_share(n: int) -> int:
    """The host threads of one of `n` ranks on this host: mpirun starts a
    rank a node, with that node's cores, so n ranks on one host get an
    n-th of its cores each."""
    return max(1, len(os.sched_getaffinity(0)) // n)


@contextlib.contextmanager
def host_threads(k: Optional[int]):
    """While open, the parallel regions this thread starts run on `k`
    threads, in torch's OpenMP runtime and in the native host libraries'
    (g++ -fopenmp links libgomp.so.1, which torch may not share); after
    it, on as many as before.  None changes nothing."""
    if not k:
        yield
        return
    try:
        omp = ctypes.CDLL("libgomp.so.1")
    except OSError:
        omp = None
    torch_before = torch.get_num_threads()
    omp_before = omp.omp_get_max_threads() if omp else None
    torch.set_num_threads(k)
    if omp:
        omp.omp_set_num_threads(k)
    try:
        yield
    finally:
        torch.set_num_threads(torch_before)
        if omp:
            omp.omp_set_num_threads(omp_before)


def rank_process(argv, log_path: str, env: dict) -> None:
    """A started rank: its output (the C libraries' too) to `log_path`,
    `env` as its environment, then `main(argv)`; ends the process with
    main's code, 1 when it raises."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    os.environ.clear()
    os.environ.update(env)
    rc = 1
    try:
        rc = main(argv)
    except BaseException:          # noqa: BLE001 (the rank's last word)
        traceback.print_exc()
    exit_rank(rc)


def gather_ranks(device: torch.device) -> None:
    """Every rank's span totals and counters of its current job (and its
    card's peak memory) to rank 0 (one `gather_object`), joined there into
    the current job (`RECORDER.join_ranks`)."""
    mine = RECORDER.snapshot()
    if device.type == "cuda":
        mine["device_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    rank = dist.get_rank()
    views = [None] * dist.get_world_size() if rank == 0 else None
    dist.gather_object(mine, views, dst=0)
    if rank == 0:
        RECORDER.join_ranks(views, 0)


class RankFailed(RuntimeError):
    """A rank of a multi-process job exited non-zero or was killed."""


class Ranks:
    """The ranks of `-n N -procs`: rank i on devices[i] over `backend`,
    rank 0 the calling process, ranks 1 .. N-1 processes it starts for each
    job (`run`, through dist/launch.py), each rank's host work on
    `threads` threads (None: the runtimes' own count).  `procs` holds the
    last job's (launch.Rank: pid, exitcode, kill, join)."""

    def __init__(self, backend: str, devices, timeout: float = RANK_TIMEOUT_S,
                 threads: Optional[int] = None):
        self.backend, self.timeout, self.threads = backend, timeout, threads
        self.devices = [torch.device(d) for d in devices]
        self.procs = []

    @classmethod
    def on_cards(cls, n: int) -> "Ranks":
        """n ranks over NCCL, rank i on cuda:i, each on its share of the
        host's cores (`host_share`).  Raises with fewer than n cards: no
        fallback to ranks sharing a card, or to the CPU."""
        _default_device()
        cards = torch.cuda.device_count()
        if cards < n:
            raise RuntimeError(f"{n} ranks need {n} CUDA cards, one a "
                               f"rank; {cards} visible")
        return cls("nccl", [torch.device("cuda", i) for i in range(n)],
                   threads=host_share(n))

    def argv(self, rank: int, coordinator: str, job_argv) -> list:
        """Rank `rank`'s arguments to `main`.  A CPU rank holds one CPU
        shard (`--local-devices 1`); a card rank takes cuda:rank
        (`rank_device`: the started ranks inherit no LOCAL_RANK)."""
        local = (["--local-devices", "1"]
                 if self.devices[rank].type == "cpu" else [])
        threads = ["--threads", str(self.threads)] if self.threads else []
        return ["--coordinator", coordinator, "--num-processes",
                str(len(self.devices)), "--process-id", str(rank),
                "--dist-backend", self.backend, *local, *threads, *job_argv]

    def buildg(self, paired_files: Sequence[str],
               single_files: Sequence[str], prefix: str,
               min_overlap: int = 30, write_par_graph_size: int = 1000,
               dist_mem: bool = False):
        """`run_buildg_sharded` on every rank, one shard each; rank 0's
        result."""
        argv = ["-f", prefix, "-m-ovl", str(min_overlap), "-w",
                str(write_par_graph_size)]
        if paired_files:
            argv += ["-pe", ",".join(paired_files)]
        if single_files:
            argv += ["-se", ",".join(single_files)]
        if dist_mem:
            argv.append("-rma")
        return self.run(lambda mesh: run_buildg_sharded(
            paired_files, single_files, prefix, mesh,
            min_overlap=min_overlap,
            write_par_graph_size=write_par_graph_size, dist_mem=dist_mem),
            argv)

    def run(self, build, job_argv):
        """One job over the ranks: start ranks 1 .. N-1 with `job_argv`
        (spans ranks.launch: until each has signalled that it is up), form
        the group (ranks.group), run build(mesh) here as rank 0 over one
        shard on devices[0], gather the ranks' records (ranks.gather), then
        destroy the group and wait for the ranks (ranks.exit); this
        process's host work on `threads` threads meanwhile.  A rank that
        exits non-zero fails the job at once (RankFailed, with its output's
        tail): the group is aborted under the collective that waits for
        it; one that stops answering fails it after `timeout` seconds.  No
        rank outlives the call."""
        with host_threads(self.threads):
            return self._job(build, job_argv)

    def _job(self, build, job_argv):
        n, device = len(self.devices), self.devices[0]
        if self.backend == "nccl":
            # a collective that times out aborts the group and raises
            # here; by default NCCL's watchdog would end this process, the
            # caller's
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        logs = pathlib.Path(tempfile.mkdtemp(prefix="disco-ranks-"))
        self.procs, dead, formed, clean = [], [], False, False
        stop = threading.Event()
        try:
            with span("ranks.launch"):
                store = dist.TCPStore(
                    "127.0.0.1", 0, n, True, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=self.timeout))
                coordinator = f"127.0.0.1:{store.port}"
                env = _rank_env()
                server = launch.launcher(env)
                for r in range(1, n):
                    self.procs.append(server.start(
                        self.argv(r, coordinator, job_argv),
                        str(logs / f"rank{r}.log"), env, self.timeout))
                self._wait_up(store, dead, logs)
            # NCCL's object collectives and barrier use the current card
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                with span("ranks.group"):
                    formed = True
                    form_group(self.backend, device, store, n, 0,
                               self.timeout)
                threading.Thread(target=self._watch, args=(stop, dead),
                                 daemon=True).start()
                out = build(process_mesh(1, device))
                with span("ranks.gather"):
                    gather_ranks(device)
            clean = True
            return out
        except Exception as e:
            # a peer's death may reach this process before the watch sees
            # it (gloo raises at once): look a moment longer
            stop.set()
            deadline = time.monotonic() + 1.0
            while (formed and not dead and not self._exited(dead)
                   and time.monotonic() < deadline):
                time.sleep(POLL_S)
            if dead:
                raise RankFailed(self._report(dead, logs)) from e
            raise
        finally:
            stop.set()
            with span("ranks.exit"):
                if formed:
                    leave_group(clean and not dead)
                self._join(EXIT_S if clean else FAILED_EXIT_S)
                shutil.rmtree(logs, ignore_errors=True)

    def _wait_up(self, store, dead, logs):
        """Until every started rank has set its key `up/<rank>`; raises
        RankFailed when one exits first, or is not up after `timeout`."""
        keys = [f"up/{r}" for r in range(1, len(self.devices))]
        deadline = time.monotonic() + self.timeout
        while not store.check(keys):
            if self._exited(dead):
                raise RankFailed(self._report(dead, logs))
            if time.monotonic() > deadline:
                raise RankFailed(f"the ranks were not up after "
                                 f"{self.timeout} s")
            time.sleep(POLL_S)

    def _exited(self, dead) -> bool:
        """Whether a started rank has exited non-zero (noted in `dead`)."""
        for r, p in enumerate(self.procs, 1):
            rc = p.exitcode
            if rc is not None and rc != 0:
                dead.append((r, rc))
                return True
        return False

    def _watch(self, stop, dead):
        """While the job runs: a rank that exits non-zero aborts this
        process's NCCL group, so that a collective waiting for it returns
        and the next call raises (gloo raises at once by itself)."""
        while not stop.wait(POLL_S):
            if self._exited(dead):
                if self.backend == "nccl":
                    try:
                        dist.distributed_c10d._get_default_group().abort()
                    except Exception as e:        # noqa: BLE001
                        log.warning("aborting the process group: %s", e)
                return

    def _join(self, grace: float):
        """Wait `grace` seconds for the started ranks, then kill the rest."""
        deadline = time.monotonic() + grace
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.01))
            if p.exitcode is None:
                p.kill()
                p.join()

    @staticmethod
    def _report(dead, logs) -> str:
        r, rc = dead[0]
        log_path = logs / f"rank{r}.log"
        text = (log_path.read_bytes()[-3000:].decode(errors="replace")
                if log_path.exists() else "")
        return f"rank {r} exited {rc}:\n{text}"


def _rank_env() -> dict:
    """A started rank's environment: this one's, without another world's
    launch variables, with the package on its path."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(_WORLD_VARS)}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_PACKAGE_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM compact nodelist: 'tpu[003-006,010],gpu7'
    -> 'tpu003'.  Only the first element is needed (the coordinator)."""
    head = nodelist.split(",")[0]
    if "[" not in head:
        return head
    prefix, _, spec = head.partition("[")
    first = spec.rstrip("]").split(",")[0].split("-")[0]
    return prefix + first


def derive_cluster_env(env=None):
    """Derive (coordinator, num_processes, process_id) from scheduler
    environment variables when they were not given explicitly — the
    equivalent of the reference's scheduler launch wrappers
    (runDisco-MPI-SLURM.sh:214 `srun`, runDisco-MPI-ALPS.sh `aprun`).

    Recognized: SLURM (srun: SLURM_PROCID/SLURM_NTASKS/SLURM_NODELIST),
    OpenMPI mpirun (OMPI_COMM_WORLD_RANK/_SIZE + coordinator from
    DISCO_TPU_COORDINATOR).  Returns (None, None, None) when nothing is
    recognized — `main` then initialises from torchrun's environment
    (`env://`)."""
    env = os.environ if env is None else env
    port = env.get("DISCO_TPU_PORT", "8476")
    if "SLURM_PROCID" in env:
        n = int(env.get("SLURM_STEP_NUM_TASKS", env.get("SLURM_NTASKS", 1)))
        pid = int(env["SLURM_PROCID"])
        nodelist = env.get("SLURM_STEP_NODELIST",
                           env.get("SLURM_JOB_NODELIST", ""))
        coord = env.get("DISCO_TPU_COORDINATOR")
        if coord is None and nodelist:
            coord = f"{first_slurm_host(nodelist)}:{port}"
        return coord, n, pid
    if "OMPI_COMM_WORLD_RANK" in env:
        coord = env.get("DISCO_TPU_COORDINATOR")
        return (coord, int(env["OMPI_COMM_WORLD_SIZE"]),
                int(env["OMPI_COMM_WORLD_RANK"]))
    return None, None, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="disco-tpu-torch-multiproc",
        description="one process of a distributed buildG run")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of rank 0 (omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="shards a rank on the CPU, over gloo (testing)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    help="process group backend: default nccl on the "
                         "cards, gloo with --local-devices; gloo lets "
                         "ranks share a card")
    ap.add_argument("--threads", type=int, default=0,
                    help="threads of this rank's host work (default: the "
                         "OpenMP runtimes' own count)")
    ap.add_argument("-pe", help="paired-end file(s), comma-sep")
    ap.add_argument("-se", help="single-end file(s), comma-sep")
    ap.add_argument("-f", required=True, help="output prefix")
    ap.add_argument("-m-ovl", dest="m_ovl", type=int, default=30)
    ap.add_argument("-w", type=int, default=1000)
    ap.add_argument("-rma", action="store_true",
                    help="dist-mem mode (partitioned read payload)")
    args = ap.parse_args(argv)

    coord, nproc, pid = args.coordinator, args.num_processes, args.process_id
    if coord is None and nproc is None and pid is None:
        # scheduler-launched (srun / mpirun) or torchrun: from the env
        coord, nproc, pid = derive_cluster_env()
    rank = pid if pid is not None else int(os.environ.get("RANK", 0))
    if args.local_devices:
        backend = args.dist_backend or "gloo"
        device = torch.device("cpu")
    else:
        device = rank_device(rank)     # no card: raise before any group
        backend = args.dist_backend or "nccl"
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the CUDA context, before "up"
    store = None
    if coord:
        host, port = coord.rsplit(":", 1)
        store = dist.TCPStore(
            host, int(port), nproc, rank == 0, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        store.set(f"up/{rank}", "1")
    form_group(backend, device, store, -1 if nproc is None else nproc, rank)
    clean = False
    try:
        with host_threads(args.threads), job("rank"):
            run_buildg_sharded(
                args.pe.split(",") if args.pe else [],
                args.se.split(",") if args.se else [], args.f,
                process_mesh(args.local_devices or 1, device),
                min_overlap=args.m_ovl, write_par_graph_size=args.w,
                dist_mem=args.rma)
            gather_ranks(device)
        clean = True
    finally:
        leave_group(clean)
    return 0


def exit_rank(rc: int) -> None:
    """Ends a rank's process with exit code `rc` once its logs and output
    are flushed, skipping the interpreter's teardown: there torch's
    process-group threads can be destroyed in any order, and now and then
    one aborts (SIGABRT, "terminate called without an active exception")
    a rank that has finished its work and left the group."""
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


if __name__ == "__main__":
    exit_rank(main())
