"""The port's host ingest modules against disco_tpu's and against the port's
own native bindings: the Python read QC (io/readqc.py, the oracle of
readqc.cpp's qc_test_reads), the 2-bit packing helpers (utils/dna.py, the
oracle of pack_reads) and the FASTA reader (io/fasta.py).
Tolerance: exact."""
import random

import numpy as np
import pytest

from conftest import GOLDEN
from disco_tpu.io import fasta as ref_fasta
from disco_tpu.io import readqc as ref_readqc
from disco_tpu.utils import dna as ref_dna
from disco_tpu_torch import native
from disco_tpu_torch.io import fasta, readqc
from disco_tpu_torch.utils import dna
from test_native_readqc import _adversarial_reads, _blob
from test_torch_native import private_native  # noqa: F401


@pytest.mark.parametrize("min_ovl", [30, 40])
def test_qc_matches_reference_and_native(min_ovl):
    reads = _adversarial_reads()
    blob, offs = _blob(reads)
    want = np.array([ref_readqc.test_read(r, min_ovl) for r in reads])
    got = np.array([readqc.test_read(r, min_ovl) for r in reads])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.qc_test_reads(blob, offs, min_ovl),
                                  want)
    assert want.any() and (~want).any()


def test_pack_matches_reference_and_native():
    rng = random.Random(3)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randrange(30, 120)))
            for _ in range(50)]
    max_len = max(map(len, seqs))
    n_words = -(-max_len // dna.BASES_PER_WORD)
    codes = np.zeros((len(seqs), max_len), np.uint8)
    codes_rc = np.zeros_like(codes)
    for i, s in enumerate(seqs):
        c = dna.encode(s)
        np.testing.assert_array_equal(c, ref_dna.encode(s))
        assert dna.revcomp(s) == ref_dna.revcomp(s)
        codes[i, :len(s)] = c
        codes_rc[i, :len(s)] = dna.encode(dna.revcomp(s))
    words = dna.pack_codes(codes, n_words)
    np.testing.assert_array_equal(words, ref_dna.pack_codes(codes, n_words))
    packed, packed_rc = native.pack_reads(*_blob(seqs), n_words)
    np.testing.assert_array_equal(packed[:, :n_words], words)
    np.testing.assert_array_equal(packed_rc[:, :n_words],
                                  dna.pack_codes(codes_rc, n_words))
    assert (packed[:, n_words] == 0).all() and (packed_rc[:, n_words] == 0).all()
    for w in words[:3, 0]:
        assert dna.unpack_word(int(w)) == ref_dna.unpack_word(int(w))
    assert dna.unpack_word(int(words[0, 0])) == seqs[0][:16]


def test_readstore_queries_match_reference():
    """ReadStore.get, get_rc and kmer_code against disco_tpu's on seeded
    read ids, starts and lengths of golden `mini`."""
    from disco_tpu.io.readstore import ReadStore as RefStore
    from disco_tpu_torch.io.readstore import ReadStore
    path = [str(GOLDEN / "mini" / "reads.fasta")]
    ref = RefStore.from_files(path, [], 30)
    store = ReadStore.from_files(path, [], 30)
    rng = np.random.default_rng(5)
    for rid in rng.integers(1, store.n_reads + 1, 40).tolist():
        seq = store.get(rid)
        assert seq == ref.get(rid) and len(seq) == store.lengths[rid - 1]
        assert store.get_rc(rid) == ref.get_rc(rid) == dna.revcomp(seq)
        start = int(rng.integers(0, len(seq) - 31))
        k = int(rng.integers(1, 32))
        assert store.kmer_code(rid, start, k) == ref.kmer_code(rid, start, k)


@pytest.mark.parametrize("name", ["p1.fasta", "p2.fasta", "se.fasta"])
def test_fasta_matches_reference(name):
    path = str(GOLDEN / "mixed" / name)
    assert list(fasta.read_records(path)) == list(
        ref_fasta.read_records(path))
    blob, offs = fasta.scan_records(path)
    want_blob, want_offs = ref_fasta.scan_records(path)
    np.testing.assert_array_equal(offs, want_offs)
    assert bytes(blob) == bytes(want_blob)
