"""Hand another implementation's read store and fingerprint table to this
package.

`state_from_reference` takes objects shaped like disco_tpu's `ReadStore`
and `FingerprintTable`, reads their fields as numpy arrays, and returns
this package's objects holding the same data.  The parity tests use it to
feed both packages identical state.  It reads attributes only and imports
nothing of disco_tpu."""
import numpy as np

from .index.table import FingerprintTable
from .io.readstore import ReadStore


def state_from_reference(store, table):
    """Returns (ReadStore, FingerprintTable) of this package."""
    lengths = np.asarray(store.lengths, np.int32)
    out_store = ReadStore(
        n_reads=len(lengths), max_len=int(store.max_len),
        n_words=int(store.n_words), lengths=lengths,
        file_index=np.asarray(store.file_index, np.int64),
        packed=np.asarray(store.packed, np.uint32),
        packed_rc=np.asarray(store.packed_rc, np.uint32),
        dataset_ranges=list(store.dataset_ranges),
        min_overlap=int(getattr(store, "min_overlap", 0)))
    out_table = FingerprintTable(
        k=int(table.k), keys=np.asarray(table.keys, np.uint64),
        read=np.asarray(table.read, np.int32),
        orient=np.asarray(table.orient, np.int8),
        typ=np.asarray(table.typ, np.int8))
    return out_store, out_table
