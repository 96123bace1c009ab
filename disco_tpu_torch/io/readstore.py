"""ReadStore — the packed read database (host numpy copy of
disco_tpu/io/readstore.py; tests/test_torch_buildg.py holds its arrays
equal to the original's).

Each read is stored once, 2-bit packed into uint32 words, plus its reverse
complement (reference: src/BuildGraph/src/HashTable.cpp:423-514 keeps the
reads inside its hash buckets instead).  The arrays stay numpy on the host;
`overlap.device.DeviceOverlapEngine` moves them to a device as int32
tensors.

Read IDs are 1-based and assigned in file order after QC, exactly like the
reference (reference: src/BuildGraph/src/Dataset.cpp:133-135). `file_index`
is the 1-based record position across all input files
(reference: src/BuildGraph/src/Dataset.cpp:183,294).
"""
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import dna
from .. import native
from . import fasta

__all__ = ["ReadStore"]


@dataclass
class ReadStore:
    n_reads: int
    max_len: int
    n_words: int
    lengths: np.ndarray          # (N,) int32
    file_index: np.ndarray       # (N,) int64, 1-based record index
    packed: np.ndarray           # (N, n_words+1) uint32 (one zero pad word)
    packed_rc: np.ndarray        # (N, n_words+1) uint32, reverse complement
    # dataset bookkeeping (paired-end ranges etc.), 1-based inclusive ID ranges
    dataset_ranges: List[Tuple[str, bool, int, int]] = field(default_factory=list)
    min_overlap: int = 0

    # reference: src/BuildGraph/src/Dataset.h:14 READ_TASK_BLOCK
    READ_TASK_BLOCK = 10000

    def __post_init__(self):
        # 15-bit read-length cap (the replay carries window offsets as
        # int16; the reference packs read length in 15 bits,
        # HashTable.cpp:437-448).  Longer reads must fail loudly.
        if self.max_len >= (1 << 15):
            raise ValueError(
                f"reads of {self.max_len} bp exceed the 15-bit length cap "
                "shared with the reference (HashTable.cpp len<<48 packing)")

    @classmethod
    def from_files(cls, paired_files: Sequence[str], single_files: Sequence[str],
                   min_overlap: int, id_map_path: Optional[str] = None,
                   reference_task_order: bool = True) -> "ReadStore":
        """reference_task_order=True replays the reference's read-ID
        assignment order: its parser batches records into OpenMP tasks of
        READ_TASK_BLOCK+1 records (reference: Dataset.cpp:295-338); with one
        thread libgomp DEFERS only the first 65 tasks (task throttling:
        a task is undeferred once team->task_count > 64 * nthreads,
        libgomp task.c), so blocks 65.. run inline at their spawn points in
        file order, the taskwait then drains the 65 deferred blocks LIFO
        (64..0), and the sub-block remainder runs inline afterwards
        (reference: Dataset.cpp:346-370).  Below 66 full blocks this
        degenerates to pure LIFO + remainder.  False gives natural file
        order."""
        per_file = []  # (blob, offsets, kept_order) for the packing pass
        findx_parts: List[np.ndarray] = []
        len_parts: List[np.ndarray] = []
        ranges: List[Tuple[str, bool, int, int]] = []
        file_index = 0
        n_kept = 0
        lines = []
        for group, is_paired in ((paired_files, True), (single_files, False)):
            for i, path in enumerate(group):
                start_id = n_kept
                start_findx = file_index
                blob, offs = fasta.scan_records(path)
                n_rec = len(offs) - 1
                keep = native.qc_test_reads(blob, offs, min_overlap)
                bs = cls.READ_TASK_BLOCK + 1
                n_blocks = (n_rec + bs - 1) // bs
                if reference_task_order and n_blocks:
                    nfull = n_blocks if n_rec % bs == 0 else n_blocks - 1
                    ndefer = min(nfull, 65)  # libgomp throttle, 1 thread
                    perm = (list(range(ndefer, nfull))         # inline @spawn
                            + list(range(ndefer - 1, -1, -1))  # taskwait LIFO
                            + ([nfull] if nfull < n_blocks else []))
                else:
                    perm = list(range(n_blocks))
                rec_order = np.concatenate(
                    [np.arange(b * bs, min((b + 1) * bs, n_rec))
                     for b in perm]) if n_blocks else np.zeros(0, np.int64)
                kept_order = rec_order[keep[rec_order]]
                per_file.append((blob, offs, kept_order))
                findx_parts.append(file_index + 1 + kept_order)
                len_parts.append(
                    (offs[kept_order + 1] - offs[kept_order]).astype(np.int32))
                n_kept += len(kept_order)
                file_index += n_rec
                if n_kept == start_id:
                    raise ValueError(f"File empty. No reads loaded from {path}")
                ranges.append((path, is_paired, start_id + 1, n_kept))
                kind = "Paired-end" if is_paired else "Singleton"
                # reference: Dataset.cpp:115-127 — the "ReadID Range" recorded
                # is actually the file-index (record) range
                lines.append(f"{path}: {kind} file {i+1}\n"
                             f"ReadID Range: ({start_findx+1},{file_index})\n")
        if id_map_path:
            # reference: src/BuildGraph/src/Dataset.cpp:103-128
            with open(id_map_path, "w") as f:
                f.writelines(lines)
        lengths = np.concatenate(len_parts)
        max_len = int(lengths.max())
        n_words = (max_len + dna.BASES_PER_WORD - 1) // dna.BASES_PER_WORD
        parts = [native.pack_reads(blob, offs, n_words, order=kept)
                 for blob, offs, kept in per_file]
        packed = parts[0][0] if len(parts) == 1 else np.vstack(
            [p[0] for p in parts])
        packed_rc = parts[0][1] if len(parts) == 1 else np.vstack(
            [p[1] for p in parts])
        store = cls(n_reads=n_kept, max_len=max_len, n_words=n_words,
                    lengths=lengths, file_index=np.concatenate(findx_parts),
                    packed=packed, packed_rc=packed_rc)
        store.dataset_ranges = ranges
        store.min_overlap = min_overlap
        return store

    @classmethod
    def from_sequences(cls, seqs: Sequence[str],
                       file_index: Optional[np.ndarray] = None) -> "ReadStore":
        n = len(seqs)
        if n == 0:
            raise ValueError("no reads")
        lengths = np.asarray([len(s) for s in seqs], np.int32)
        max_len = int(lengths.max())
        n_words = (max_len + dna.BASES_PER_WORD - 1) // dna.BASES_PER_WORD
        blob = "".join(seqs).encode()
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lengths, out=offs[1:])
        packed, packed_rc = native.pack_reads(blob, offs, n_words)
        if file_index is None:
            file_index = np.arange(1, n + 1, dtype=np.int64)
        return cls(n_reads=n, max_len=max_len, n_words=n_words,
                   lengths=lengths, file_index=file_index,
                   packed=packed, packed_rc=packed_rc)

    # ------------------------------------------------------------------ query
    def get(self, read_id: int) -> str:
        """Forward string of 1-based read_id (debug/host use)."""
        i = read_id - 1
        length = int(self.lengths[i])
        out = []
        for w in self.packed[i]:
            out.append(dna.unpack_word(int(w)))
        return "".join(out)[:length]

    def get_rc(self, read_id: int) -> str:
        i = read_id - 1
        length = int(self.lengths[i])
        out = []
        for w in self.packed_rc[i]:
            out.append(dna.unpack_word(int(w)))
        return "".join(out)[:length]

    def kmer_code(self, read_id: int, start: int, k: int) -> int:
        """2-bit code of bases [start, start+k) of the forward read (host)."""
        s = self.get(read_id)[start:start + k]
        code = 0
        for ch in s:
            code = (code << 2) | "ACGT".index(ch)
        return code
