"""Read quality-control filter — exact behavioral port of the reference's
Dataset::testRead (reference: src/BuildGraph/src/Dataset.cpp:403-451) plus the
length gate applied at its call sites (len > minOverlap,
reference: src/BuildGraph/src/Dataset.cpp:305).

A read is rejected if any of:
- length <= minOverlap, or length < MIN_READ_SIZE (30)
  (reference: src/BuildGraph/src/Dataset.h:15);
- contains a non-ACGT character;
- any single base makes up >= 70% of the read
  (reference: src/BuildGraph/src/Dataset.cpp:415-417);
- starts or ends with one of 38 hard-coded micro-repeat strings
  (reference: src/BuildGraph/src/Dataset.cpp:48-85); NOTE: reads shorter than
  a filter string (29 bp) are rejected outright by the same loop — subsumed
  by MIN_READ_SIZE;
- any of 16 di/tri-mers (and "GGGGCC") covers >= 50% of the read via
  non-overlapping occurrence count × mer length
  (reference: src/BuildGraph/src/Dataset.cpp:87,430-438).
"""
MIN_READ_SIZE = 30

# reference: src/BuildGraph/src/Dataset.cpp:48-85 (duplicates preserved;
# they are harmless but kept for fidelity of documentation)
FILTER_STRINGS = [
    "ACACACACACACACACACACACACACACA",
    "AGAGAGAGAGAGAGAGAGAGAGAGAGAGA",
    "ATATATATATATATATATATATATATATA",
    "CGCGCGCGCGCGCGCGCGCGCGCGCGCGC",
    "CTCTCTCTCTCTCTCTCTCTCTCTCTCTC",
    "AAGAAGAAGAAGAAGAAGAAGAAGAAGAA",
    "ATAATAATAATAATAATAATAATAATAAT",
    "TAATAATAATAATAATAATAATAATAATA",
    "AACAACAACAACAACAACAACAACAACAA",
    "ACAACAACAACAACAACAACAACAACAAC",
    "CAACAACAACAACAACAACAACAACAACA",
    "AAGAAGAAGAAGAAGAAGAAGAAGAAGAA",
    "AGAAGAAGAAGAAGAAGAAGAAGAAGAAG",
    "GAAGAAGAAGAAGAAGAAGAAGAAGAAGA",
    "TTCTTCTTCTTCTTCTTCTTCTTCTTCTT",
    "AAATAAATAAATAAATAAATAAATAAATA",
    "TAAATAAATAAATAAATAAATAAATAAAT",
    "ATAAATAAATAAATAAATAAATAAATAAA",
    "AATAAATAAATAAATAAATAAATAAATAA",
    "AATTAATTAATTAATTAATTAATTAATTA",
    "ATTAATTAATTAATTAATTAATTAATTAA",
    "TTAATTAATTAATTAATTAATTAATTAAT",
    "TAATTAATTAATTAATTAATTAATTAATT",
    "AAAGAAAGAAAGAAAGAAAGAAAGAAAGA",
    "AAAGAAAGAAAGAAAGAAAGAAAGAAAGA",
    "AGAAAGAAAGAAAGAAAGAAAGAAAGAAA",
    "GAAAGAAAGAAAGAAAGAAAGAAAGAAAG",
    "TACATACATACATACATACATACATACAT",
    "ACATACATACATACATACATACATACATA",
    "CATACATACATACATACATACATACATAC",
    "ATACATACATACATACATACATACATACA",
    "GTTTGTTTGTTTGTTTGTTTGTTTGTTTG",
    "TGTTTGTTTGTTTGTTTGTTTGTTTGTTT",
    "TTTGTTTGTTTGTTTGTTTGTTTGTTTGT",
    "AGGGAGGGAGGGAGGGAGGGAGGGAGGGA",
    "GAGGGAGGGAGGGAGGGAGGGAGGGAGGG",
    "GGAGGGAGGGAGGGAGGGAGGGAGGGAGG",
    "GGGAGGGAGGGAGGGAGGGAGGGAGGGAG",
]

# reference: src/BuildGraph/src/Dataset.cpp:87
MER_CHECK_STRINGS = [
    "AC", "AG", "AT", "CG", "CT", "GT",
    "AAT", "ATA", "TAA", "AAC", "ACA", "CAA",
    "AAG", "AGA", "GAA", "GGGGCC",
]

_ACGT = set("ACGT")


def count_substring_nonoverlapping(s: str, sub: str) -> int:
    """Non-overlapping occurrence count
    (reference: src/BuildGraph/src/Common.h:173-183)."""
    if not sub:
        return 0
    count = 0
    off = s.find(sub)
    while off != -1:
        count += 1
        off = s.find(sub, off + len(sub))
    return count


def test_read(read: str, min_overlap: int) -> bool:
    n = len(read)
    if n <= min_overlap:
        return False
    if n < MIN_READ_SIZE:
        return False
    counts = [0, 0, 0, 0]
    for ch in read:
        if ch not in _ACGT:
            return False
        # reference indexes counts by (ascii >> 1) & 3: A->0 C->1 T->2 G->3;
        # only the max count matters so any bijection works
        counts["ACTG".index(ch)] += 1
    threshold = int(n * 0.7)
    if max(counts) >= threshold:
        return False
    for fs in FILTER_STRINGS:
        m = len(fs)
        if n < m:
            return False
        if read[:m] == fs or read[n - m:] == fs:
            return False
    threshold = int(n * 0.5)
    for mer in MER_CHECK_STRINGS:
        if count_substring_nonoverlapping(read, mer) * len(mer) >= threshold:
            return False
    return True
