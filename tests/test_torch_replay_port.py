"""The port's traversal (native/port/replay.cpp: native.replay_walk and
ReplayWalk.text, what buildg.replay runs) against the JAX package's copy
native/src/replay.cpp (native.graph_replay) and against the Python oracle
buildg.replay.build_graph_replay: golden `mini` and `ecoli` and a
20,000-read set with planted 29 bp repeats (discobench/lib/gen.py), at
write_par_graph_size 1, 7 and 1000, fresh and resumed from a mid-file
start read with the marks of the partial parGraph; and random groups that
reach what real relations do not.  Exact: the parGraph and
_startRead.txt bytes, the chunk ends and the marked reads."""
import numpy as np
import pytest

from conftest import GOLDEN
from discobench.lib.gen import write_reads
from disco_tpu_torch import native
from disco_tpu_torch.buildg import replay
from disco_tpu_torch.index.table import FingerprintTable
from disco_tpu_torch.io.readstore import ReadStore
from disco_tpu_torch.overlap.relation import compute_relation

CASES = ("mini", "ecoli", "gen20k")
WPGS = (1, 7, 1000)
# the Python oracle where it takes seconds, not minutes
ORACLE = (("mini", 1), ("mini", 7), ("mini", 1000), ("ecoli", 1000),
          ("gen20k", 1000))


@pytest.fixture(scope="module")
def case_state(tmp_path_factory):
    """case -> (store, relation, superread, (starts, ej, er2, eo))."""
    made = {}

    def get(case):
        if case not in made:
            if case == "gen20k":
                path = tmp_path_factory.mktemp("gen20k") / "reads.fasta"
                write_reads(str(path), 2200021001, genome_len=200_000,
                            reads=20_000, repeats={"families": 20,
                                                   "copies": 4,
                                                   "length": 29})
            else:
                path = GOLDEN / case / "reads.fasta"
            store = ReadStore.from_files([str(path)], [], 30)
            table = FingerprintTable.build(store, 29)
            rel = compute_relation(store, table, backend="native")
            superread, _ = replay.containment_replay(rel, store)
            contained = (superread != 0).astype(np.uint8)
            groups = native.edge_hit_groups(rel.r1, rel.j, rel.r2,
                                            rel.orient, rel.edge_ok,
                                            contained, store.n_reads)
            made[case] = store, rel, superread, groups
        return made[case]

    return get


@pytest.fixture(scope="module")
def fresh_src(case_state):
    """(case, wpgs) -> native/src's outputs of a fresh run and its marks."""
    made = {}

    def get(case, wpgs):
        if (case, wpgs) not in made:
            store, rel, superread, groups = case_state(case)
            marked = _marks(superread)
            made[case, wpgs] = native.graph_replay(
                store.n_reads, rel.k, wpgs, *groups, store.lengths,
                store.file_index, marked), marked
        return made[case, wpgs]

    return get


def _marks(superread, premarked=None):
    marked = (superread != 0).astype(np.uint8)
    if premarked is not None:
        marked |= premarked
    marked[0] = 1
    return marked


@pytest.mark.parametrize("resumed", (False, True), ids=("fresh", "resumed"))
@pytest.mark.parametrize("wpgs", WPGS)
@pytest.mark.parametrize("case", CASES)
def test_walk_matches_native_src(case_state, fresh_src, case, wpgs, resumed,
                                 tmp_path):
    store, rel, superread, groups = case_state(case)
    (full, starts_blob, ends), m_full = fresh_src(case, wpgs)
    marked, start_read, head = _marks(superread), 1, b""
    if resumed:
        # killed during chunk c: chunks [0, c) flushed, c's start recorded
        c = len(ends) // 2
        assert c >= 1, "too few chunks to resume in the middle"
        head = full[:ends[c - 1]]
        (tmp_path / "part.txt").write_bytes(head)
        premarked = replay.load_partial_marks(str(tmp_path / "part.txt"),
                                              store)
        marked = _marks(superread, premarked)
        start_read = int(starts_blob.splitlines()[c])
    args = (store.n_reads, rel.k, wpgs, *groups, store.lengths)
    m_port = marked.copy()
    walk = native.replay_walk(*args, m_port, start_read=start_read)
    port = walk.text(store.file_index, store.lengths)
    if resumed:
        m_src = marked.copy()
        src = native.graph_replay(*args, store.file_index, m_src,
                                  start_read=start_read)
    else:
        src, m_src = (full, starts_blob, ends), m_full
    assert port[0] == src[0]
    assert port[1] == src[1]
    np.testing.assert_array_equal(port[2], src[2])
    np.testing.assert_array_equal(m_port, m_src)
    assert walk.lines == port[0].count(b"\n")
    assert len(port[2]) == len(port[1].splitlines())
    if resumed:
        assert head + port[0] == full


@pytest.mark.parametrize("case,wpgs", ORACLE)
def test_walk_matches_python_oracle(case_state, case, wpgs):
    store, rel, superread, groups = case_state(case)
    want = replay.build_graph_replay(rel, store, superread, wpgs)
    par, _, _ = replay.graph_replay_from_groups(store, rel.k, *groups,
                                                superread, wpgs)
    assert par.decode() == "".join(ln + "\n" for ln in want)


@pytest.mark.parametrize("seed", range(12))
def test_walk_matches_native_src_on_random_rows(seed):
    """Random groups over 300 reads, which real relations never give: runs
    of more than four rows at one window (the per-window cap), one read
    twice in a group (the dedupe), rows of a read with itself, long
    lists of tied offsets, reads with no rows; every write size."""
    rng = np.random.default_rng(seed)
    n, k = 300, 29
    lens = rng.integers(60, 120, n).astype(np.int32)
    counts = rng.integers(0, 40, n + 1)
    counts[0] = 0
    counts[rng.random(n + 1) < 0.1] = 0
    starts = np.cumsum(counts).astype(np.int64)
    rows = int(starts[-1])
    r1 = np.repeat(np.arange(1, n + 1), counts[1:])
    ej = rng.integers(0, 8, rows)
    ej = np.concatenate([np.sort(ej[starts[r - 1]:starts[r]])
                         for r in range(1, n + 1)]).astype(np.int16)
    near = r1 + rng.integers(-12, 13, rows)
    er2 = np.where(rng.random(rows) < 0.02, r1,
                   np.clip(near, 1, n)).astype(np.int32)
    eo = rng.integers(0, 4, rows).astype(np.int8)
    fidx = rng.permutation(n).astype(np.int64)
    marked = (rng.random(n + 1) < 0.05).astype(np.uint8)
    marked[0] = 1
    for wpgs in (1, 3, 1000):
        m_src, m_port = marked.copy(), marked.copy()
        src = native.graph_replay(n, k, wpgs, starts, ej, er2, eo, lens,
                                  fidx, m_src)
        walk = native.replay_walk(n, k, wpgs, starts, ej, er2, eo, lens,
                                  m_port)
        port = walk.text(fidx, lens)
        assert port[0] == src[0] and port[1] == src[1], wpgs
        np.testing.assert_array_equal(port[2], src[2])
        np.testing.assert_array_equal(m_port, m_src)
