"""GFA / GFA2 graph export
(reference: src/SimplifyGraph/src/OverlapGraph.cpp:3779-3947).

Byte-faithful to the reference writers, including their quirks: the GFA1
header says VN:Z:2.0, middle links reuse the PREVIOUS inner read's
orientation for the source column, and the GFA2 '+/-' argument swap in
generateGFA2Edge's branches."""
from typing import TextIO

from .engine import FullGraph


def write_gfa(graph: FullGraph, f: TextIO) -> None:
    d = graph.d
    f.write("H\tVN:Z:2.0\n")
    path_id = 0
    for i in range(1, d.size() + 1):
        f.write(f"S\t{i}\t{d.read_len(i)}\t*\n")
        lst = graph.g.get(i)
        if not lst:
            continue
        for e in lst:
            src, dst = e.src, e.dst
            f_ori = "+" if e.orient in (2, 3) else "-"
            l_ori = "+" if e.orient in (1, 3) else "-"
            if not (src < dst or (src == dst and e.addr < e.twin.addr)):
                continue
            if e.inner.n > 0:
                inner = e.inner.flat()
                (r0, o0, off0) = inner[0]
                ori = "-" if o0 == 0 else "+"
                f.write(f"L\t{src}\t{f_ori}\t{r0}\t{ori}\t"
                        f"{e.src_len - off0}M\n")
                path = f"{src}{f_ori},"
                path_ovl = f"{e.src_len - off0}M,"
                for j in range(1, len(inner)):
                    (rj_1, oj_1, _) = inner[j - 1]
                    (rj, oj, offj) = inner[j]
                    ori1 = "-" if oj_1 == 0 else "+"
                    f.write(f"L\t{rj_1}\t{ori1}\t")
                    path += f"{rj_1}{ori1},"
                    ori2 = "-" if oj == 0 else "+"
                    f.write(f"{rj}\t{ori2}\t"
                            f"{d.read_len(rj_1) - offj}M\n")
                    path_ovl += f"{d.read_len(rj_1) - offj}M,"
                (rl, ol, _) = inner[-1]
                ori = "-" if ol == 0 else "+"
                last_ovl = (d.read_len(rl)
                            - (e.offset - e.inner.offset_sum(0, e.inner.n)))
                f.write(f"L\t{rl}\t{ori}\t{dst}\t{l_ori}\t{last_ovl}M\n")
                path += f"{dst}{l_ori}"
                path_ovl = path_ovl[:-1]
                path_id += 1
                f.write(f"P\t{path_id}\t{path}\t{path_ovl}\n")
            else:
                f.write(f"L\t{src}\t{f_ori}\t{dst}\t{l_ori}\t{e.offset}\n")


def _gfa2_edge(graph: FullGraph, f: TextIO, edge_id: int, source: int,
               s_ori: str, destination: int, d_ori: str, offset: int) -> None:
    d = graph.d
    slen = d.read_len(source)
    ovl = slen - offset
    if s_ori == "+" and d_ori == "+":
        f.write(f"E\t{edge_id}\t{source}\t{s_ori}\t{destination}\t"
                f"{offset}\t{slen}$\t0\t{ovl}\t{ovl}M\n")
    if s_ori == "+" and d_ori == "-":
        f.write(f"E\t{edge_id}\t{source}\t{d_ori}\t{destination}\t"
                f"{offset}\t{slen}$\t{slen - ovl}\t{slen}$\t{ovl}M\n")
    elif s_ori == "-" and d_ori == "+":
        f.write(f"E\t{edge_id}\t{destination}\t{s_ori}\t{source}\t"
                f"0\t{ovl}$\t{slen - ovl}\t{slen}$\t{ovl}M\n")
    elif s_ori == "-" and d_ori == "-":
        dlen = d.read_len(destination)
        f.write(f"E\t{edge_id}\t{source}\t{d_ori}\t{destination}\t"
                f"0\t{ovl}$\t{dlen}$\t{dlen - ovl}$\t{ovl}M\n")


def write_gfa2(graph: FullGraph, f: TextIO) -> None:
    d = graph.d
    f.write("H\tVN:Z:2.0\n")
    path_id = 0
    edge_id = 0
    for i in range(1, d.size() + 1):
        f.write(f"S\t{i}\t{d.read_len(i)}\t*\n")
        lst = graph.g.get(i)
        if not lst:
            continue
        for e in lst:
            src, dst = e.src, e.dst
            f_ori = "+" if e.orient in (2, 3) else "-"
            l_ori = "+" if e.orient in (1, 3) else "-"
            if not (src < dst or (src == dst and e.addr < e.twin.addr)):
                continue
            if e.inner.n > 0:
                inner = e.inner.flat()
                (r0, o0, off0) = inner[0]
                edge_id += 1
                _gfa2_edge(graph, f, edge_id, src, f_ori, r0,
                           "-" if o0 == 0 else "+", off0)
                path = f"{edge_id}\t"
                for j in range(1, len(inner)):
                    (rj_1, oj_1, _) = inner[j - 1]
                    (rj, oj, offj) = inner[j]
                    edge_id += 1
                    _gfa2_edge(graph, f, edge_id, rj_1,
                               "-" if oj_1 == 0 else "+", rj,
                               "-" if oj == 0 else "+", offj)
                    path += f"{edge_id}\t"
                (rl, ol, _) = inner[-1]
                edge_id += 1
                _gfa2_edge(graph, f, edge_id, rl, "-" if ol == 0 else "+",
                           dst, l_ori,
                           e.offset - e.inner.offset_sum(0, e.inner.n))
                path += f"{edge_id}"
                path_id += 1
                f.write(f"PO\t{path_id}\t{path}\n")
            else:
                edge_id += 1
                _gfa2_edge(graph, f, edge_id, src, f_ori, dst, l_ori,
                           e.offset)
