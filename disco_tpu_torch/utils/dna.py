"""DNA alphabet utilities shared by host and device code.

Base encoding is alphabetical 2-bit: A=0, C=1, G=2, T=3 (complement = 3-x).
(The reference stores bases with the same alphabetical encoding in its hash
data table, reference: src/BuildGraph/src/HashTable.h BASE_A..BASE_T.)
"""
import numpy as np

# ASCII -> 2-bit code; 255 marks non-ACGT.
_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i

_RC_TRANS = bytes.maketrans(b"ACGT", b"TGCA")

BASES_PER_WORD = 16  # 2-bit bases per uint32 word


def encode(seq: str) -> np.ndarray:
    """ASCII string -> uint8 code array (255 for non-ACGT)."""
    return _LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]


def revcomp(seq: str) -> str:
    return seq.encode().translate(_RC_TRANS)[::-1].decode()


def pack_codes(codes: np.ndarray, n_words: int) -> np.ndarray:
    """Pack a (N, L) uint8 code matrix into (N, n_words) uint32, 16 bases per
    word, base i in bits [30-2*(i%16), 32-2*(i%16)) of word i//16 (big-endian
    within the word, matching the reference's packing direction,
    reference: src/BuildGraph/src/HashTable.cpp:456-477 modulo word width).
    Codes past each row's length must already be zero."""
    n, length = codes.shape
    pad = n_words * BASES_PER_WORD - length
    if pad < 0:
        raise ValueError("n_words too small")
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    grouped = codes.reshape(n, n_words, BASES_PER_WORD).astype(np.uint32)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    return (grouped << shifts).sum(axis=2, dtype=np.uint32)


def unpack_word(word: int, count: int = BASES_PER_WORD) -> str:
    out = []
    for i in range(count):
        out.append("ACGT"[(word >> (30 - 2 * i)) & 3])
    return "".join(out)
