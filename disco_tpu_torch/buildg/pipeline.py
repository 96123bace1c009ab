"""buildG-equivalent front end: reads -> contained reads + overlap edges
(the counterpart of disco_tpu/buildg/pipeline.py).

Writes files bit-identical to a single-threaded reference `buildG` run
(reference: src/BuildGraph/src/main.cpp:24-73):
  <prefix>_ReadIDMap.txt, <prefix>_0_containedReads.txt,
  <prefix>_0_parGraph.txt, <prefix>_CheckpointInfo.txt

Checkpoint/restart (reference: main.cpp:45-52,178-204): GC=Complete skips
graph construction entirely; CCR=Complete reuses the contained-read file
from the previous run instead of recomputing containment.
"""
import os
from typing import Optional, Sequence

import numpy as np

from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..overlap.relation import BACKEND_ENV, compute_relation, default_backend
from ..utils.logging import clock
from . import replay


def read_checkpoint_info(prefix: str):
    """Returns (contained_read_complete, graph_complete)."""
    ccr = gc = False
    try:
        with open(prefix + "_CheckpointInfo.txt") as f:
            for line in f:
                if "=" not in line:
                    continue
                name, _, val = line.strip().partition("=")
                if name.strip() == "CCR" and val.strip() == "Complete":
                    ccr = True
                if name.strip() == "GC" and val.strip() == "Complete":
                    gc = True
    except OSError:
        pass
    return ccr, gc


def load_contained_reads(path: str, store: ReadStore) -> np.ndarray:
    """Rebuild the superread table from an existing _containedReads.txt
    (reference restart path: src/BuildGraph/src/OverlapGraph.cpp:336-377 —
    decuple file indices map back to read IDs via the fileIndex map)."""
    rid_of_fidx = {int(f): i + 1 for i, f in enumerate(store.file_index)}
    superread = np.zeros(store.n_reads + 1, np.int64)
    with open(path) as f:
        for line in f:
            toks = line.split("\t")
            if len(toks) < 2:
                continue
            contained = rid_of_fidx.get(int(toks[0]))
            containing = rid_of_fidx.get(int(toks[1]))
            if contained and containing:
                superread[contained] = containing
    return superread


def run_buildg(paired_files: Sequence[str], single_files: Sequence[str],
               prefix: str, min_overlap: int = 30,
               write_par_graph_size: int = 1000,
               store: Optional[ReadStore] = None,
               max_mem_gb: Optional[int] = None,
               backend: Optional[str] = None, device=None):
    """Full graph-construction phase. Returns (store, relation, superread).

    backend: "device" (the torch pipeline on `device`, default the CUDA
    card), "native" (C++ host kernel) or "xla" (exact host expansion);
    None picks `default_backend()`.  An explicit backend (argument or
    DISCO_TPU_TORCH_BACKEND) always runs; an auto-selected one gives way to
    the native two-pass protocol below 2^20 windows.

    The native backend runs the bounded-memory TWO-PASS protocol (the
    reference's own structure: markContainedReads first, then edge
    generation skipping contained reads, OverlapGraph.cpp:333,435-436);
    max_mem_gb (the CLI's -m) switches it to the one-pass relation when the
    budget covers ~6x the reads-file size.  Outputs are byte-identical
    either way."""
    ccr_done, gc_done = read_checkpoint_info(prefix)
    if gc_done:
        return None, None, None

    # per-stage telemetry mirrors the reference's CLOCKSTART/CLOCKSTOP
    # (reference: src/BuildGraph/src/Common.h:71-72)
    if store is None:
        with clock("readDataset"):
            store = ReadStore.from_files(paired_files, single_files,
                                         min_overlap,
                                         id_map_path=prefix + "_ReadIDMap.txt")
    with clock("insertDataset"):
        table = FingerprintTable.build(store, min_overlap - 1)

    backend_forced = backend is not None or bool(os.environ.get(BACKEND_ENV))
    backend = backend or default_backend()
    n_win = int(store.lengths.sum()) - store.n_reads * (min_overlap - 1)
    two_pass = backend == "native" or (not backend_forced
                                       and n_win < (1 << 20))
    if two_pass and max_mem_gb:
        fasta_gb = sum(os.path.getsize(p)
                       for p in (*paired_files, *single_files)) / (1 << 30)
        if max_mem_gb >= 6 * fasta_gb + 2:
            two_pass = False

    rel = None
    if not two_pass:
        with clock("overlapRelation"):
            rel = compute_relation(store, table, backend=backend,
                                   device=device)

    cont_path = prefix + "_0_containedReads.txt"
    if ccr_done and os.path.exists(cont_path):
        superread = load_contained_reads(cont_path, store)
    else:
        with clock("markContainedReads"):
            if two_pass:
                from .. import native
                cont = native.overlap_relation_mode(
                    store.packed, store.packed_rc, store.lengths,
                    table.keys, table.read, table.orient, table.typ,
                    table.k, mode=1)
                superread = np.zeros(store.n_reads + 1, np.int64)
                cont_lines = []
                replay.containment_step(superread, cont_lines, store,
                                        table.k, cont["r1"], cont["j"],
                                        cont["r2"], cont["orient"])
                del cont
            else:
                superread, cont_lines = replay.containment_replay(rel, store)
        with open(cont_path, "w") as f:
            for ln in cont_lines:
                f.write(ln + "\n")
        # reference: OverlapGraph.cpp:486-493 — CCR checkpoint after the
        # contained-read phase
        with open(prefix + "_CheckpointInfo.txt", "w") as f:
            f.write("CCR=Complete\n")

    # incremental restart (reference: OverlapGraph.cpp:123-211): if a
    # partial parGraph exists, reload the marked bitmap from its records,
    # resume the BFS from the last _startRead.txt line, and APPEND new
    # chunks; _startRead.txt carries only this run's chunk starts
    par_path = prefix + "_0_parGraph.txt"
    sr_path = prefix + "_0_startRead.txt"
    start_read = 1
    premarked = None
    mode = "wb"
    if os.path.exists(par_path) and os.path.getsize(par_path) > 0:
        premarked = replay.load_partial_marks(par_path, store)
        start_read = replay.read_start_read(sr_path)
        mode = "ab"
    with clock("buildOverlapGraphFromHashTable"):
        if two_pass:
            from .. import native
            n = store.n_reads
            contained = (superread[1:n + 1] != 0).astype(np.uint8)
            starts, ej, er2, eo = native.overlap_relation_mode2_grouped(
                store.packed, store.packed_rc, store.lengths, table.keys,
                table.read, table.orient, table.typ, table.k, contained)
            del contained
            par_blob, start_blob, _ = replay.graph_replay_from_groups(
                store, table.k, starts, ej, er2, eo,
                superread, write_par_graph_size,
                start_read=start_read, premarked=premarked)
        else:
            par_blob, start_blob, _ = replay.build_graph_replay_native(
                rel, store, superread, write_par_graph_size,
                start_read=start_read, premarked=premarked)
    with open(par_path, mode) as f:
        f.write(par_blob)
    with open(sr_path, "wb") as f:
        f.write(start_blob)
    # reference: main.cpp:63-70 appends GC=Complete
    with open(prefix + "_CheckpointInfo.txt", "a") as f:
        f.write("GC=Complete\n")
    return store, rel, superread
