"""Cytoscape-style graph dump
(reference: ostream operator<< on OverlapGraph, OverlapGraph.cpp:1891-1989;
the shipped build always takes the "cytoscape" branch: a TSV of the
length-sorted smaller edges)."""
from typing import TextIO

from .engine import FullGraph


def write_cytoscape(graph: FullGraph, f: TextIO) -> None:
    edges = graph.get_edges()
    f.write("source\ttarget\tfirtOvl\tcontigLen\tnumReads\toffset\t"
            "lastOvl\tedgeType\n")
    for e in edges:
        if e.is_smaller():
            f.write(f"{e.src}\t{e.dst}\t{e.overlap_len()}\t"
                    f"{e.edge_length()}\t{e.inner.n}\t{e.offset}\t"
                    f"{e.twin.overlap_len()}\t{e.orient}\n")
