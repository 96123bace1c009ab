"""One process per rank: the distributed buildG over `torch.distributed`
(the counterpart of disco_tpu/dist/multiproc.py; reference:
runDisco-MPI.sh:214 `mpirun -np N buildG-MPI ...`).

- every rank joins one process group (`init_process_group`, the MPI_Init
  equivalent) and holds a contiguous block of the mesh's shards
  (`mesh.process_mesh`);
- every rank parses every input and builds the store and the table on the
  host: the reference's replicated parse (reference:
  src/BuildGraphMPI/src/HashTable.cpp:53, every rank builds the full
  table);
- each superstep, each rank computes its shards' slice of the query axis
  (and, with -rma, holds only its shards' slice of the packed payload);
  the exchanges run over the process group, and the hit grids come back
  to every rank (`dist.builder`'s collect, one `all_gather` a grid);
- every rank runs the same deterministic replay; rank 0 writes the output
  files; a barrier ends the run.

The files are byte-identical to the single-process build's, whatever the
rank count and mode.  The relation is unpruned, as in disco_tpu: its rows
equal the one-process `sharded_relation`'s at the same shard count.  Where
disco_tpu raises on a cap overflow, every rank re-runs the chunk exactly
(`builder._chunk_fallback`) and gets the same rows.

Launch (one process a rank):
  python -m disco_tpu_torch.dist.multiproc --coordinator HOST:PORT \\
      --num-processes N --process-id I -pe reads.fasta -f PREFIX [-rma]
Under torchrun (`env://`: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) or
srun / mpirun (`derive_cluster_env`) the rank needs no arguments.  Each
rank takes one shard on cuda:(LOCAL_RANK or rank) % cards over NCCL;
`--dist-backend gloo` lets ranks share a card (NCCL refuses two ranks on
one card); `--local-devices L` runs L shards a rank on the CPU over gloo
(testing)."""
import argparse
import logging
import os
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..buildg import replay
from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..overlap.relation import _default_device
from ..utils.logging import clock
from .builder import sharded_relation
from .mesh import Mesh, process_mesh


def sharded_relation_multiproc(store, table, mesh: Mesh,
                               hit_cap: Optional[int] = None,
                               route_cap: Optional[int] = None,
                               budget: int = 1 << 25,
                               dist_mem: bool = False):
    """disco_tpu's multi-process relation, with its arguments: the
    one-process `sharded_relation` over a mesh that spans the processes
    (`process_mesh`), whose collect gathers every shard's hit grids to
    every rank.  Call it on every rank; every rank returns the same
    relation (its `stats` count chunks and fallback chunks)."""
    return sharded_relation(store, table, mesh, route_cap=route_cap,
                            budget=budget, dist_mem=dist_mem,
                            hit_cap=hit_cap)


def rank_device() -> torch.device:
    """This rank's card: cuda:(LOCAL_RANK or rank) % cards."""
    _default_device()          # raises without a card
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def run_buildg_multiproc(paired_files: Sequence[str],
                         single_files: Sequence[str], prefix: str,
                         min_overlap: int = 30,
                         write_par_graph_size: int = 1000,
                         dist_mem: bool = False,
                         mesh: Optional[Mesh] = None):
    """Distributed buildG across the initialised process group.  `mesh`
    defaults to one shard a rank on its card (`rank_device`).  Rank 0
    writes the output files; every rank returns (store, relation,
    superread)."""
    rank = dist.get_rank()
    if mesh is None:
        mesh = process_mesh(1, rank_device())
    with clock("readDataset"):
        store = ReadStore.from_files(
            paired_files, single_files, min_overlap,
            id_map_path=(prefix + "_ReadIDMap.txt" if rank == 0 else None))
    with clock("insertDataset"):
        table = FingerprintTable.build(store, min_overlap - 1)
    with clock("overlapRelation"):
        rel = sharded_relation_multiproc(store, table, mesh,
                                         dist_mem=dist_mem)

    # the replay is deterministic and cheap beside the overlap phase:
    # every rank computes it (no broadcast), rank 0 writes
    with clock("buildOverlapGraphFromHashTable"):
        superread, cont_lines = replay.containment_replay(rel, store)
        par_blob, start_blob, _ = replay.build_graph_replay_native(
            rel, store, superread, write_par_graph_size)
    if rank == 0:
        with open(prefix + "_0_containedReads.txt", "w") as f:
            for ln in cont_lines:
                f.write(ln + "\n")
        with open(prefix + "_0_parGraph.txt", "wb") as f:
            f.write(par_blob)
        with open(prefix + "_CheckpointInfo.txt", "w") as f:
            f.write("CCR=Complete\nGC=Complete\n")
        with open(prefix + "_0_startRead.txt", "wb") as f:
            f.write(start_blob)
    dist.barrier()
    return store, rel, superread


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
    ap.add_argument("-pe", help="paired-end file(s), comma-sep")
    ap.add_argument("-se", help="single-end file(s), comma-sep")
    ap.add_argument("-f", required=True, help="output prefix")
    ap.add_argument("-m-ovl", dest="m_ovl", type=int, default=30)
    ap.add_argument("-w", type=int, default=1000)
    ap.add_argument("-rma", action="store_true",
                    help="dist-mem mode (partitioned read payload)")
    args = ap.parse_args(argv)

    if args.local_devices:
        backend = args.dist_backend or "gloo"
    else:
        _default_device()      # no card: raise before any group forms
        backend = args.dist_backend or "nccl"
    coord, nproc, pid = args.coordinator, args.num_processes, args.process_id
    if coord is None and nproc is None and pid is None:
        # scheduler-launched (srun / mpirun) or torchrun: from the env
        coord, nproc, pid = derive_cluster_env()
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}" if coord else "env://",
        world_size=-1 if nproc is None else nproc,
        rank=-1 if pid is None else pid)
    try:
        if args.local_devices:
            mesh = process_mesh(args.local_devices, torch.device("cpu"))
        else:
            device = rank_device()
            torch.cuda.set_device(device)
            mesh = process_mesh(1, device)
        run_buildg_multiproc(
            args.pe.split(",") if args.pe else [],
            args.se.split(",") if args.se else [],
            args.f, min_overlap=args.m_ovl, write_par_graph_size=args.w,
            dist_mem=args.rma, mesh=mesh)
    finally:
        dist.destroy_process_group()
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
