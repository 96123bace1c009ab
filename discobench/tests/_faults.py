"""The faults a cell can have, each planted in the program under a
pytest MonkeyPatch: the timed path broken underneath a run, which must
then come out not correct.  The CPU tests plant them in tiny cells
(test_discobench_faults.py); test_discobench_card.py reads them on the
card at the cells' own size."""
import dataclasses
import glob

import numpy as np


def half_the_answers(monkeypatch):
    """Half of the dual check's batch left out: the odd slots' answers of
    every K2 call dropped."""
    from disco_tpu_torch.overlap import device
    real = device.fused_compare_dual_fetch

    def half(*a, **kw):
        edge_ok, cont_ok = real(*a, **kw)
        edge_ok, cont_ok = edge_ok.clone(), cont_ok.clone()
        edge_ok[1::2] = False
        cont_ok[1::2] = False
        return edge_ok, cont_ok
    monkeypatch.setattr(device, "fused_compare_dual_fetch", half)


def k2_accepts_all(monkeypatch):
    """K2 answers true in every slot: every candidate whose k-mer matches
    passes both checks."""
    import torch
    from disco_tpu_torch.overlap import device

    def accept(table, b, rows1, *geo):
        ones = torch.ones(rows1.shape[0], dtype=torch.bool,
                          device=rows1.device)
        return ones, ones.clone()
    monkeypatch.setattr(device, "fused_compare_dual_fetch", accept)


def k2_half_words(monkeypatch):
    """K2 compares fewer words: the first half of each edge and
    containment window, the precision below the whole window."""
    from disco_tpu_torch.overlap import device
    real = device.fused_compare_dual_fetch

    def half(table, b, rows1, e_o1, e_o2, e_n, c_o1, c_n):
        return real(table, b, rows1, e_o1, e_o2, e_n // 2, c_o1, c_n // 2)
    monkeypatch.setattr(device, "fused_compare_dual_fetch", half)


def altered_line(monkeypatch):
    """An answer altered where it is produced: the replay writes one edge
    of the graph to another read.  (A relation row altered on one side
    need not show: the replay skips a row whose read 2 it has explored,
    and takes the edge from read 2's own row.)"""
    from disco_tpu_torch.buildg import replay
    real = replay.build_graph_replay_native

    def altered(*a, **kw):
        par, start, ends = real(*a, **kw)
        lines = par.split(b"\n")
        f = lines[len(lines) // 2].split(b"\t")
        f[1] = str(int(f[1]) + 7).encode()
        lines[len(lines) // 2] = b"\t".join(f)
        return b"\n".join(lines), start, ends
    monkeypatch.setattr(replay, "build_graph_replay_native", altered)


def state_unchanged(monkeypatch):
    """The relation step returns without a row, as if it had not run."""
    from disco_tpu_torch.buildg import pipeline
    real = pipeline.compute_relation

    def empty(store, table, **kw):
        rel = real(store, table, **kw)
        keep = np.zeros(len(rel), bool)
        return dataclasses.replace(
            rel, **{f: getattr(rel, f)[keep] for f in
                    ("r1", "j", "r2", "orient", "typ", "cont_ok",
                     "edge_ok")})
    monkeypatch.setattr(pipeline, "compute_relation", empty)


def _after_fullsimplify(monkeypatch, kind, edit):
    """`edit(records)` applied to the (header, sequence) records of every
    <prefix>_<kind>Final_*.fasta that fullsimplify wrote."""
    from disco_tpu_torch.simplify import driver
    real = driver.run_fullsimplify

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        for path in sorted(glob.glob(f"{a[5]}_{kind}Final_*.fasta")):
            with open(path) as f:
                text = f.read()
            recs = [r.split("\n", 1) for r in text.split(">")[1:]]
            recs = [(h, s.replace("\n", "")) for h, s in recs]
            with open(path, "w") as f:
                f.writelines(f">{h}\n{s}\n" for h, s in edit(recs))
        return out
    monkeypatch.setattr(driver, "run_fullsimplify", wrapped)


def altered_contig(monkeypatch):
    """A base of the first contig altered as fullsimplify writes it."""
    def edit(recs):
        h, s = recs[0]
        s = s[:40] + "ACGT"[("ACGT".index(s[40]) + 1) % 4] + s[41:]
        return [(h, s)] + recs[1:]
    _after_fullsimplify(monkeypatch, "contigs", edit)


def half_the_contigs(monkeypatch):
    """fullsimplify writes every other contig."""
    _after_fullsimplify(monkeypatch, "contigs", lambda recs: recs[::2])


def scaffolds_cut(monkeypatch):
    """The scaffold stage writes each scaffold cut to its first half."""
    _after_fullsimplify(monkeypatch, "scaffolds",
                        lambda recs: [(h, s[:len(s) // 2]) for h, s in recs])


GRAPH = (half_the_answers, k2_accepts_all, k2_half_words, altered_line,
         state_unchanged)
ASSEMBLY = (altered_contig, half_the_contigs, scaffolds_cut)
