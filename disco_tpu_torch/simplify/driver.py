"""fullsimplify driver: the iteration/phase pipeline
(reference: src/SimplifyGraph/src/main.cpp:30-294).

Phase snapshots are written with the same names the patched oracle produces
(<prefix>_phase_<name>_<iter>.txt) so parity tests diff them directly.
"""
import os
from typing import List, Optional

from ..utils.logging import clock, log, span
from .core import Alloc
from .dataset import SimplifyDataset
from .engine import FullGraph
from .params import Params
from ..native import parsimplify_run as parsimplify_native
from .pargraph import parsimplify  # Python parity oracle (tests)

assert parsimplify  # noqa: the oracle stays importable from the driver


def run_fullsimplify(single_files: List[str], pair_files: List[str],
                     inter_pair_files: List[str], edge_files: List[str],
                     contained_files: List[str], prefix: str,
                     param_files: Optional[List[str]] = None,
                     max_iters: int = 3,
                     sim_path: Optional[str] = None,
                     on_disk_snapshot=None) -> SimplifyDataset:
    """Equivalent of `fullsimplify -fs/-fp/-fpi ... -e ... -crd ... -o ...`.

    param_files: up to three cfg paths (iteration 1..3); missing entries
    reuse the defaults-only state like the reference would fail — pass all
    three for parity runs.
    sim_path: `-simPth` — directory whose test/<thresh>.txt tables feed the
    benchmark-specific contig post-processing (streamContigsThresh).
    on_disk_snapshot: test hook invoked after every periodic in-loop
    graph checkpoint (reference: DISK_GRAPH_UPDATE, Config.h:53); may
    raise to simulate a mid-phase kill.

    The whole call is the span `fullsimplify` (utils/logging.py), its
    `clock` stages its children: its self time is what no stage owns, the
    phase dumps and checkpoint writes between them.
    """
    with span("fullsimplify"):
        dataset = SimplifyDataset(single_files, pair_files, inter_pair_files)
        dataset.store_contained_read_info(contained_files)

        params = Params()

        # resume state (reference: readCheckpointInfo, main.cpp:316-374)
        phase_done, ctg_count, scf_count, start_iter = read_checkpoint_info(
            prefix + "_SimplificationCheckpointInfo.txt", max_iters)

        def checkpoint(line: str) -> None:
            with open(prefix + "_SimplificationCheckpointInfo.txt", "a") as f:
                f.write(line + "\n")

        for iteration in range(start_iter, max_iters + 1):
            dataset.clear_edge_info()
            for i in range(1, dataset.size() + 1):
                dataset.used[i] = False
            if param_files:
                params.set_parameters(param_files[min(iteration - 1,
                                                      len(param_files) - 1)])
            cont = _simplify_iteration(dataset, params, edge_files, prefix,
                                       iteration, checkpoint,
                                       single_files, pair_files,
                                       inter_pair_files, ctg_count, scf_count,
                                       phase_done[iteration - 1],
                                       sim_path=sim_path,
                                       on_disk_snapshot=on_disk_snapshot)
            ctg_count = cont["ctg_count"]
            scf_count = cont["scf_count"]
            if not cont["continue"]:
                break
        if params.print_unused:
            write_unused_reads(dataset, prefix)
        return dataset


# phase indices (reference checkpoint keys, main.cpp:343-362)
P_PARSIMPLIFY, P_INITIAL, P_AGGRESSIVE, P_FLOW, P_POSTFLOW, P_CTG, \
    P_SCAFFOLD = range(7)


def read_checkpoint_info(path: str, max_iters: int):
    """reference: readCheckpointInfo (main.cpp:316-374).  Returns
    (phase_done per iteration, ctg_count, scf_count, start_iteration)."""
    phase_done = [[0] * 7 for _ in range(max_iters)]
    ctg = scf = 0
    try:
        f = open(path)
    except OSError:
        return phase_done, 0, 0, 1
    with f:
        it = 1
        for line in f:
            if "=" not in line:
                continue
            name, _, val = line.strip().partition("=")
            name = name.strip()
            val = val.strip()
            if name == "Iteration":
                it = int(val)
            elif name == "ParSimplify" and val == "1":
                phase_done[it - 1][P_PARSIMPLIFY] = 1
            elif name == "InitialSimplify" and val == "1":
                phase_done[it - 1][P_INITIAL] = 1
            elif name == "AggressiveSimplify" and val == "1":
                phase_done[it - 1][P_AGGRESSIVE] = 1
            elif name == "FlowAnalysis" and val == "1":
                phase_done[it - 1][P_FLOW] = 1
            elif name == "PostFlowAnalysis" and val == "1":
                phase_done[it - 1][P_POSTFLOW] = 1
            elif name == "PrintCtg":
                phase_done[it - 1][P_CTG] = 1
                ctg = int(val)
            elif name == "Scaffold":
                phase_done[it - 1][P_SCAFFOLD] = 1
                scf = int(val)
    for i in range(max_iters):
        if any(v == 0 for v in phase_done[i]):
            return phase_done, ctg, scf, i + 1
    return phase_done, ctg, scf, 1


def write_unused_reads(dataset: SimplifyDataset, prefix: str) -> None:
    """reference: DataSet::writeUnUsedReads + printUnusedReads
    (DataSet.cpp:441-614): per dataset, emit reads where the read or its
    mate is unused."""
    from .dataset import iter_fasta_records

    def emit(path: str, start_rid: int, out) -> None:
        # The reference's FASTA walk consumes each record's '>' as the
        # getline delimiter of the PREVIOUS record's sequence, so every
        # header line0 lacks the marker EXCEPT the first file record
        # (DataSet.cpp:501-528); output is '>' + line0, giving '>>name'
        # only for record 1.  FASTQ keeps its '@' on every record.
        rid = start_rid
        for i, (raw_header, seq) in enumerate(iter_fasta_records(path)):
            hdr = raw_header
            if i > 0 and hdr.startswith(">"):
                hdr = hdr[1:]
            mate = dataset.mate_pair(rid)
            if mate != 0:
                if not dataset.used[rid] or not dataset.used[mate]:
                    out.write(f">{hdr}\n{seq}\n")
            else:
                if not dataset.used[rid]:
                    out.write(f">{hdr}\n{seq}\n")
            rid += 1

    for ds in dataset.datasets:
        d = ds.number
        if ds.is_paired and ds.is_interleaved:
            with open(f"{prefix}_{d}_UnusedPairedReads.fasta", "w") as f:
                emit(ds.r1_file, ds.r1_start, f)
        elif ds.is_paired:
            with open(f"{prefix}_{d}_UnusedPairedReads1.fasta", "w") as f:
                emit(ds.r1_file, ds.r1_start, f)
            with open(f"{prefix}_{d}_UnusedPairedReads2.fasta", "w") as f:
                emit(ds.r2_file, ds.r2_start, f)
        else:
            with open(f"{prefix}_{d}_UnusedSingleReads.fasta", "w") as f:
                emit(ds.r1_file, ds.r1_start, f)


def _simplify_iteration(dataset: SimplifyDataset, params: Params,
                        edge_files: List[str], prefix: str, iteration: int,
                        checkpoint, single_files, pair_files,
                        inter_pair_files, ctg_count: int = 0,
                        scf_count: int = 0,
                        phase_done: Optional[List[int]] = None,
                        sim_path: Optional[str] = None,
                        on_disk_snapshot=None) -> dict:
    if phase_done is None:
        phase_done = [0] * 7
    checkpoint(f"Iteration={iteration}")
    total_reads = dataset.size()
    used_reads = 0
    for i in range(1, iteration):
        used_reads += dataset.load_used_reads(
            f"{prefix}_UsedReads_{i}.txt")
    if used_reads > params.max_reads_used * total_reads:
        return {"continue": False, "ctg_count": 0, "scf_count": 0}

    # --- phase 0: per-partition simplification + load + contract ----------
    graph = FullGraph(dataset, params)
    # periodic mid-loop re-serialization target (reference:
    # OverlapGraph.cpp:1183-1188,1282-1289)
    graph.checkpoint_path = f"{prefix}_CurrGraph_.txt"
    graph.on_disk_snapshot = on_disk_snapshot
    if phase_done[P_PARSIMPLIFY] == 0:
        with clock("parSimplifyAndLoad"):
            from ..utils.logging import malloc_trim
            for i, ef in enumerate(edge_files):
                out = f"{prefix}_{i}_ParSimpleEdges.txt"
                if not os.path.exists(out):
                    parsimplify_native(ef, out, params.min_ovl)
                    # the native parsimplify arena is freed but glibc
                    # retains the pages; trim so the engine load doesn't
                    # stack on top of them (the reference runs
                    # parsimplify as a separate process)
                    malloc_trim()
                graph.read_par_edges(out)
            graph.sort_edges_by_dest()
            while graph.contract_composite_par() > 0:
                pass
            malloc_trim()
        graph.print_all_edges(f"{prefix}_phase_parsimplify_{iteration}.txt",
                              f"{prefix}_CurrGraph_.txt")
        checkpoint("ParSimplify=1")
    else:
        # resume: reload the checkpoint graph (reference: the parGlobalGraph
        # ctor, OverlapGraph.cpp:1139-1160)
        graph.read_par_edges(f"{prefix}_CurrGraph_.txt")
        while graph.contract_composite_par() > 0:
            pass

    # --- phase 1: initial simplification -----------------------------------
    if phase_done[P_INITIAL] == 0:
        with clock("graphPathFindInitial"):
            graph.graph_path_find_initial()
        graph.print_all_edges(f"{prefix}_phase_initial_{iteration}.txt",
                              f"{prefix}_CurrGraph_.txt")
        checkpoint("InitialSimplify=1")

    # --- phase 2: aggressive simplification ---------------------------------
    if phase_done[P_AGGRESSIVE] == 0:
        with clock("simplifyGraph"):
            graph.simplify_graph()
        graph.print_all_edges(f"{prefix}_phase_aggressive_{iteration}.txt",
                              f"{prefix}_CurrGraph_.txt")
        checkpoint("AggressiveSimplify=1")

    # --- phase 3: flow analysis --------------------------------------------
    if phase_done[P_FLOW] == 0:
        with clock("calculateFlowStream"):
            graph.calculate_flow(dimacs_dump=f"{prefix}_dimacs_dump.txt")
            graph.remove_edges_without_flow()
        graph.print_all_edges(f"{prefix}_phase_flow_{iteration}.txt",
                              f"{prefix}_CurrGraph_.txt")
        checkpoint("FlowAnalysis=1")

    # --- phase 4: post-flow simplification ----------------------------------
    if phase_done[P_POSTFLOW] == 0:
        with clock("postFlowSimplify"):
            graph.simplify_graph()
        graph.print_all_edges(f"{prefix}_phase_postflow_{iteration}.txt",
                              f"{prefix}_CurrGraph_.txt")
        checkpoint("PostFlowAnalysis=1")

    from . import scaffold as _scaffold
    from . import contigs as _contigs

    # --- phase 5: contigs (reference: main.cpp:186-205) ---------------------
    if params.print_contigs:
        size = dataset.size()
        use_thresh = (size in _contigs.REF_THRESH
                      or size // 1_000_000 in _contigs.REF_THRESH)
        out_args = (
            graph, single_files, pair_files, inter_pair_files,
            f"{prefix}_contigsFinal_{iteration}.fasta",
            f"{prefix}_contigEdgesFinal_{iteration}.txt",
            f"{prefix}_contigEdgeCoverageFinal_{iteration}.txt",
            f"{prefix}_UsedReads_{iteration}.txt",
            "contig", ctg_count)
        with clock("streamContigs"):
            if use_thresh:
                ctg_count = _contigs.stream_contigs_thresh(
                    *out_args, sim_path=sim_path)
            else:
                ctg_count = _contigs.stream_contigs(*out_args)
        graph.print_all_edges(f"{prefix}_phase_printctg_{iteration}.txt",
                              f"{prefix}_CurrGraph_.txt")
        checkpoint(f"PrintCtg={ctg_count}")

    # --- GFA export (reference: main.cpp:207-227) ---------------------------
    if params.print_gfa:
        from . import gfa as _gfa
        with open(f"{prefix}_Graph_{iteration}.gfa", "w") as f:
            _gfa.write_gfa(graph, f)
    if params.print_gfa2:
        from . import gfa as _gfa
        with open(f"{prefix}_Graph_{iteration}.gfa2", "w") as f:
            _gfa.write_gfa2(graph, f)

    # --- phase 6: scaffolding ----------------------------------------------
    with clock("scaffold"):
        _scaffold.scaffold_phase(graph)
    if params.print_scaffolds:
        with clock("streamScaffolds"):
            scf_count = _contigs.stream_contigs(
                graph, single_files, pair_files, inter_pair_files,
                f"{prefix}_scaffoldsFinal_{iteration}.fasta",
                f"{prefix}_scaffoldEdgesFinal_{iteration}.txt",
                f"{prefix}_scaffoldEdgeCoverageFinal_{iteration}.txt",
                f"{prefix}_UsedReads_{iteration}.txt",
                "scaff", scf_count)
    graph.print_all_edges(f"{prefix}_phase_scaffold_{iteration}.txt",
                          f"{prefix}_CurrGraph_.txt")
    checkpoint(f"Scaffold={scf_count}")

    # --- used-read accounting (main.cpp:273-291) ---------------------------
    import numpy as np
    used = 0
    for i in np.flatnonzero(dataset.used[1:]) + 1:
        used += dataset.recursive_contained_count(int(i)) + 1
    cont = used <= params.max_reads_used * total_reads
    return {"continue": cont, "ctg_count": ctg_count,
            "scf_count": scf_count}
