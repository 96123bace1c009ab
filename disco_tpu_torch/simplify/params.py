"""Simplification parameters, mirroring the reference's Config globals and
key=value parameter files (reference: src/SimplifyGraph/src/Config.cpp).

The reference keeps one mutable global set; `set_parameters` applies a cfg
file on top of the current state exactly like Config::setParameters —
including the one-way boolean flips (e.g. PrintContigs only ever goes
false->true; PrintScaffolds only true->false; Config.cpp:250-268)."""
from dataclasses import dataclass, field
from typing import List


@dataclass
class Params:
    # defaults = Config.cpp:40-75
    min_ovl: int = 20
    min_reads_not_dead_end: int = 5
    min_len_not_dead_end: int = 500
    min_reads_0_flow: int = 2
    min_len_0_flow: int = 200
    min_reads_1_min_flow: int = 5
    min_len_1_min_flow: int = 500
    min_ovl_to_clip: int = 30
    min_ovl_diff_to_clip: int = 10
    min_fold_short_branch: int = 5
    min_size_short_branch: int = 200
    min_uniq_support: int = 3
    min_nonuniq_support: int = 0
    min_read_used: float = 0.3
    min_mate_read_unused: float = 0.9
    min_contig_length: int = 300
    min_reads_to_print: int = 2
    max_reads_used: float = 0.7
    print_contigs: bool = False
    print_scaffolds: bool = True
    print_unused: bool = False
    print_gfa: bool = False
    print_gfa2: bool = False
    # periodic in-loop graph checkpoint cadence, seconds (reference:
    # DISK_GRAPH_UPDATE, src/SimplifyGraph/src/Config.h:53 -- a compile-time
    # constant there; exposed as the cfg key DiskGraphUpdate here)
    disk_graph_update: float = 18000.0

    _KEYMAP = {
        "minReadsCountInEdgeToBeNotDeadEnd": ("min_reads_not_dead_end", int),
        "minEdgeLengthToBeNotDeadEnd": ("min_len_not_dead_end", int),
        "minReadsCountInEdgeToBe1MinFlow": ("min_reads_1_min_flow", int),
        "minEdgeLengthToBe1MinFlow": ("min_len_1_min_flow", int),
        "minReadsCountToHave0Flow": ("min_reads_0_flow", int),
        "minEdgeLengthToHave0Flow": ("min_len_0_flow", int),
        "minSequenceLengthTobePrinted": ("min_contig_length", int),
        "minNumberofReadsTobePrinted": ("min_reads_to_print", int),
        "minOverlapDifference4ClipBranches": ("min_ovl_diff_to_clip", int),
        "minFoldToBeShortBranch": ("min_fold_short_branch", int),
        "MinOverlap4Clip": ("min_ovl_to_clip", int),
        "minUniquePEsupport": ("min_uniq_support", int),
        "minNonUniquePEsupport": ("min_nonuniq_support", int),
        "MinOverlap4SimplifyGraph": ("min_ovl", int),
        "minSizeToBeShortBranch": ("min_size_short_branch", int),
        "maxReadsUsed": ("max_reads_used", float),
        "DiskGraphUpdate": ("disk_graph_update", float),
    }

    def set_parameters(self, cfg_path: str) -> None:
        """Apply a key=value file (reference: Config::setParameters,
        Config.cpp:100-172).  Note stoi semantics: leading numeric prefix
        parsed, trailing junk ignored."""
        with open(cfg_path) as f:
            for line in f:
                t = line.strip()
                if "=" not in t or not t or t[0] == "#":
                    continue
                name, _, val = t.partition("=")
                name = name.strip()
                val = val.strip()
                if name in self._KEYMAP:
                    attr, typ = self._KEYMAP[name]
                    if typ is int:
                        setattr(self, attr, int(val.split()[0]))
                    else:
                        setattr(self, attr, float(val.split()[0]))
                elif name == "MinOverlap4BuildGraph":
                    continue
                elif name == "PrintContigs":
                    if val == "true":
                        self.print_contigs = True
                elif name == "PrintUnused":
                    if val == "true":
                        self.print_unused = True
                elif name == "PrintGFA":
                    if val == "true":
                        self.print_gfa = True
                elif name == "PrintGFA2":
                    if val == "true":
                        self.print_gfa2 = True
                elif name == "PrintScaffolds":
                    if val == "false":
                        self.print_scaffolds = False
                else:
                    raise ValueError(f"Unknown parameter: {name}")


# constants (reference: src/SimplifyGraph/src/OverlapGraph.h:18-24)
LOOP_LIMIT = 15
EXPLORE_DEPTH = 100
INSERT_SIZE_RANGE_SD = 3
MAX_INNER_DIST_TRESH = 100

# benchmark-specific N50 fixup table (reference: Utils.cpp:671-679)
REF_THRESH = {22286068: 60000, 107690098: 62300, 107: 62300,
              106998276: 62300, 770: 102100, 146: 2800}
