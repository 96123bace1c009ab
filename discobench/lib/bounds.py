"""The yardstick of the dual check (K2, and K1 on a chunk re-run): its
roofline bound, from the work the reads ask of it.

The arithmetic is a frozen copy of chip_smoke.py's `bound` and
`window_bound` (the H100 SXM data sheet's 3.35 TB/s of HBM and 67e12
32-bit operations a second; about 5 operations a compared word: two funnel
shifts, XOR, mask, compare).  The work is counted from the reads, not from
the route the program takes: every window of every read (j in [0, L - k))
against every table entry with its k-mer (each read's prefix and suffix,
forward and reverse-complemented; palindromes once), the geometry of each
such candidate as the reference assembler checks it (OverlapGraph.cpp:
517-595, the program's `candidate_geometry`), and the words its edge and
containment windows compare.  Bytes, each input byte once: the data words
of every distinct row the candidates read (read 1 forward; read 2 forward
or reverse-complemented), 12 B a candidate (read 1, window, read 2 with its
orientation) and 1 B of answer.  Padding slots, a second read of a row, or
a geometry the program stages do not count."""
import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
OPS_PER_WORD = 5
PAIR_BYTES = 12 + 1


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time the card takes: the larger of the bytes over its
    memory rate and the operations over its 32-bit rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def _pack(codes: torch.Tensor) -> torch.Tensor:
    """(M, k) base codes -> (M,) int64 keys, first base highest."""
    key = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    for t in range(codes.shape[1]):
        key = key * 4 + codes[:, t].long()
    return key


def dual_check_work(codes: torch.Tensor, k: int, block: int = 1 << 15
                    ) -> dict:
    """The dual check's work over reads `codes` ((N, L) uint8, one length,
    on any device) with (MinOverlap - 1)-mer windows: candidates, compared
    words, distinct rows, bytes and operations."""
    n, length = codes.shape
    dev = codes.device
    pref, suf = codes[:, :k], codes[:, length - k:]
    pref_rc, suf_rc = (3 - pref).flip(1), (3 - suf).flip(1)
    rid = torch.arange(n, device=dev)
    pal_p = (pref == pref_rc).all(1)
    pal_s = (suf == suf_rc).all(1)
    keys = torch.cat([_pack(pref), _pack(suf), _pack(pref_rc)[~pal_p],
                      _pack(suf_rc)[~pal_s]])
    reads = torch.cat([rid, rid, rid[~pal_p], rid[~pal_s]])
    orient = torch.cat([torch.zeros(n, dtype=torch.long, device=dev),
                        torch.ones(n, dtype=torch.long, device=dev),
                        torch.full((int((~pal_p).sum()),), 3, device=dev),
                        torch.full((int((~pal_s).sum()),), 2, device=dev)])
    keys, order = torch.sort(keys)
    reads, orient = reads[order], orient[order]

    n_win = length - k
    pairs = words = 0
    rows2 = torch.zeros(2 * n, dtype=torch.bool, device=dev)
    for s in range(0, n, block):
        c = codes[s:s + block].long()
        b = c.shape[0]
        code = torch.zeros((b, n_win), dtype=torch.int64, device=dev)
        for t in range(k):
            code = code * 4 + c[:, t:t + n_win]
        code = code.reshape(-1)
        lo = torch.searchsorted(keys, code)
        hi = torch.searchsorted(keys, code, right=True)
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            continue
        win = torch.repeat_interleave(torch.arange(len(code), device=dev),
                                      cnt)
        rank = torch.arange(total, device=dev) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        pos = lo[win] + rank
        r1 = s + win // n_win
        j = win % n_win
        r2, o = reads[pos], orient[pos]
        # candidate_geometry: window lengths of the edge and containment
        # checks, 0 where the reference does not check (all reads L long)
        suffix_case = (o & 1) == 1
        e_valid = torch.where(suffix_case, j <= length - k,
                              (length - j) < length)
        e_valid &= (j >= 1) & (r1 != r2)
        e_n = torch.where(e_valid, torch.where(suffix_case, j + k,
                                               length - j), 0)
        c_valid = torch.where(suffix_case, j >= length - k,
                              j + length <= length) & (r1 != r2)
        c_n = torch.where(c_valid, length, 0)
        pairs += total
        words += int(((e_n + 15) >> 4).sum() + ((c_n + 15) >> 4).sum())
        rows2[r2 + torch.where(o >= 2, n, 0)] = True
    row_bytes = 4 * (-(-length // 16))
    distinct_rows = n + int(rows2.sum())
    nbytes = row_bytes * distinct_rows + PAIR_BYTES * pairs
    ops = OPS_PER_WORD * words
    return {"candidates": pairs, "compared_words": words,
            "distinct_rows": distinct_rows, "bytes": nbytes, "ops": ops,
            "bound_s": bound_seconds(nbytes, ops)}
