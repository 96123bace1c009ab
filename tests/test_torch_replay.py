"""The port's Python traversal replay (disco_tpu_torch.buildg.replay:
build_graph_replay, the single-threaded oracle of native/src/replay.cpp)
against disco_tpu's and against the port's native replay, on golden `mini`
and `ecoli` (over 10,001 records: the reference's task-block read order),
from the same relation; and the ReadStore queries (get, get_rc,
kmer_code) against disco_tpu's.  Tolerance: exact, line for line and byte
for byte."""
import numpy as np
import pytest

from conftest import GOLDEN
from disco_tpu.buildg import replay as ref_replay
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import compute_relation
from disco_tpu_torch.buildg import replay
from disco_tpu_torch.convert import state_from_reference
from disco_tpu_torch.overlap.relation import compute_relation as relation
from test_torch_native import private_native  # noqa: F401


@pytest.mark.parametrize("case,wsize", [("mini", 1000), ("ecoli", 20000)])
def test_replay_oracle_matches_reference_and_native(case, wsize):
    store = ReadStore.from_files([str(GOLDEN / case / "reads.fasta")], [], 30)
    table = FingerprintTable.build(store, 29)
    want_rel = compute_relation(store, table, backend="native")
    superread, _ = ref_replay.containment_replay(want_rel, store)
    want = ref_replay.build_graph_replay(want_rel, store, superread, wsize)

    pstore, ptable = state_from_reference(store, table)
    rel = relation(pstore, ptable, backend="native")
    got_superread, _ = replay.containment_replay(rel, pstore)
    np.testing.assert_array_equal(got_superread, superread)
    got = replay.build_graph_replay(rel, pstore, superread, wsize)
    assert got == want
    blob, _, _ = replay.build_graph_replay_native(rel, pstore, superread,
                                                  wsize)
    assert blob.decode() == "".join(ln + "\n" for ln in got)
    assert blob == (GOLDEN / case / f"{case}_0_parGraph.txt").read_bytes()
    # the edge-eligible hits grouped by read, as both packages group them
    for g, w in zip(replay._edge_hit_groups(rel, pstore, superread),
                    ref_replay._edge_hit_groups(want_rel, store, superread)):
        np.testing.assert_array_equal(g, w)
