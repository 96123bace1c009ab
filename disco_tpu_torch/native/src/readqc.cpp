// Read QC + 2-bit packing, native host path.
// Exact behavioral port of disco_tpu/io/readqc.py::test_read (itself a port
// of the reference's Dataset::testRead,
// reference: src/BuildGraph/src/Dataset.cpp:403-451, filter strings :48-85,
// mer table :87, non-overlapping counting Common.h:173-183) and of
// disco_tpu/utils/dna.py::pack_codes (A=0 C=1 G=2 T=3, 16 bases per uint32,
// big-endian within the word; reference packing direction:
// src/BuildGraph/src/HashTable.cpp:456-477).
#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t MIN_READ_SIZE = 30;

const char* const FILTER_STRINGS[] = {
    "ACACACACACACACACACACACACACACA", "AGAGAGAGAGAGAGAGAGAGAGAGAGAGA",
    "ATATATATATATATATATATATATATATA", "CGCGCGCGCGCGCGCGCGCGCGCGCGCGC",
    "CTCTCTCTCTCTCTCTCTCTCTCTCTCTC", "AAGAAGAAGAAGAAGAAGAAGAAGAAGAA",
    "ATAATAATAATAATAATAATAATAATAAT", "TAATAATAATAATAATAATAATAATAATA",
    "AACAACAACAACAACAACAACAACAACAA", "ACAACAACAACAACAACAACAACAACAAC",
    "CAACAACAACAACAACAACAACAACAACA", "AAGAAGAAGAAGAAGAAGAAGAAGAAGAA",
    "AGAAGAAGAAGAAGAAGAAGAAGAAGAAG", "GAAGAAGAAGAAGAAGAAGAAGAAGAAGA",
    "TTCTTCTTCTTCTTCTTCTTCTTCTTCTT", "AAATAAATAAATAAATAAATAAATAAATA",
    "TAAATAAATAAATAAATAAATAAATAAAT", "ATAAATAAATAAATAAATAAATAAATAAA",
    "AATAAATAAATAAATAAATAAATAAATAA", "AATTAATTAATTAATTAATTAATTAATTA",
    "ATTAATTAATTAATTAATTAATTAATTAA", "TTAATTAATTAATTAATTAATTAATTAAT",
    "TAATTAATTAATTAATTAATTAATTAATT", "AAAGAAAGAAAGAAAGAAAGAAAGAAAGA",
    "AAAGAAAGAAAGAAAGAAAGAAAGAAAGA", "AGAAAGAAAGAAAGAAAGAAAGAAAGAAA",
    "GAAAGAAAGAAAGAAAGAAAGAAAGAAAG", "TACATACATACATACATACATACATACAT",
    "ACATACATACATACATACATACATACATA", "CATACATACATACATACATACATACATAC",
    "ATACATACATACATACATACATACATACA", "GTTTGTTTGTTTGTTTGTTTGTTTGTTTG",
    "TGTTTGTTTGTTTGTTTGTTTGTTTGTTT", "TTTGTTTGTTTGTTTGTTTGTTTGTTTGT",
    "AGGGAGGGAGGGAGGGAGGGAGGGAGGGA", "GAGGGAGGGAGGGAGGGAGGGAGGGAGGG",
    "GGAGGGAGGGAGGGAGGGAGGGAGGGAGG", "GGGAGGGAGGGAGGGAGGGAGGGAGGGAG",
};
constexpr int N_FILTER = sizeof(FILTER_STRINGS) / sizeof(FILTER_STRINGS[0]);

const char* const MER_STRINGS[] = {
    "AC", "AG", "AT", "CG", "CT", "GT",
    "AAT", "ATA", "TAA", "AAC", "ACA", "CAA",
    "AAG", "AGA", "GAA", "GGGGCC",
};
constexpr int N_MER = sizeof(MER_STRINGS) / sizeof(MER_STRINGS[0]);

// non-overlapping occurrence count (reference: Common.h:173-183)
inline int64_t count_nonoverlap(const char* s, int64_t n, const char* sub,
                                int64_t m) {
  int64_t count = 0, i = 0;
  while (i + m <= n) {
    if (std::memcmp(s + i, sub, m) == 0) {
      ++count;
      i += m;
    } else {
      ++i;
    }
  }
  return count;
}

inline int code_of(unsigned char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

// Prescreen codes for the mer filter: a non-overlapping occurrence count is
// bounded by the OVERLAPPING count of any substring of the mer, so one
// histogram pass over the read lets almost every exact scan be skipped
// ("GGGGCC" is screened by its "GC" dimer).  The exact count_nonoverlap is
// only run when the bound clears the threshold, so results are unchanged.
struct MerScreen {
  int8_t kind;   // 2 = dimer code, 3 = trimer code
  int8_t code;
};
constexpr MerScreen MER_SCREEN[N_MER] = {
    {2, 0x1}, {2, 0x2}, {2, 0x3}, {2, 0x6}, {2, 0x7}, {2, 0xB},
    {3, 003}, {3, 014}, {3, 060}, {3, 001}, {3, 004}, {3, 020},
    {3, 002}, {3, 010}, {3, 040}, {2, 0x9 /* GC of GGGGCC */},
};

inline bool test_read(const char* s, int64_t n, int64_t min_overlap) {
  if (n <= min_overlap || n < MIN_READ_SIZE) return false;
  int64_t counts[4] = {0, 0, 0, 0};
  int64_t dimer[16] = {0};
  int64_t trimer[64] = {0};
  int c0 = code_of(static_cast<unsigned char>(s[0]));
  if (c0 < 0) return false;
  ++counts[c0];
  int prev = c0, prev2 = -1;
  for (int64_t i = 1; i < n; ++i) {
    int c = code_of(static_cast<unsigned char>(s[i]));
    if (c < 0) return false;
    ++counts[c];
    ++dimer[(prev << 2) | c];
    if (prev2 >= 0) ++trimer[(prev2 << 4) | (prev << 2) | c];
    prev2 = prev;
    prev = c;
  }
  int64_t maxc = counts[0];
  for (int k = 1; k < 4; ++k)
    if (counts[k] > maxc) maxc = counts[k];
  if (maxc >= static_cast<int64_t>(n * 0.7)) return false;
  for (int f = 0; f < N_FILTER; ++f) {
    const char* fs = FILTER_STRINGS[f];
    int64_t m = static_cast<int64_t>(std::strlen(fs));
    if (n < m) return false;
    if (std::memcmp(s, fs, m) == 0 || std::memcmp(s + n - m, fs, m) == 0)
      return false;
  }
  int64_t half = static_cast<int64_t>(n * 0.5);
  for (int f = 0; f < N_MER; ++f) {
    const char* mer = MER_STRINGS[f];
    int64_t m = static_cast<int64_t>(std::strlen(mer));
    const MerScreen& ms = MER_SCREEN[f];
    const int64_t bound =
        (ms.kind == 2) ? dimer[static_cast<int>(ms.code)]
                       : trimer[static_cast<int>(ms.code)];
    if (bound * m < half) continue;
    if (count_nonoverlap(s, n, mer, m) * m >= half) return false;
  }
  return true;
}

}  // namespace

extern "C" void qc_test_reads(const char* data, const int64_t* offsets,
                              int64_t n, int64_t min_overlap, uint8_t* out) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t i = 0; i < n; ++i)
    out[i] = test_read(data + offsets[i], offsets[i + 1] - offsets[i],
                       min_overlap) ? 1 : 0;
}

// Pack reads into (n, n_words+1) uint32 rows (last word zero pad), forward
// and reverse-complement.  Returns the index of the first read containing a
// non-ACGT base, or -1 on success.  `order` (may be null for identity)
// selects which record lands in each output row: row i <- record order[i].
extern "C" int64_t pack_reads_ordered(const char* data,
                                      const int64_t* offsets,
                                      const int64_t* order, int64_t n,
                                      int64_t n_words, uint32_t* packed,
                                      uint32_t* packed_rc) {
  const int64_t stride = n_words + 1;
  int64_t bad = -1;
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t rec = order ? order[i] : i;
    const char* s = data + offsets[rec];
    const int64_t len = offsets[rec + 1] - offsets[rec];
    uint32_t* pf = packed + i * stride;
    uint32_t* pr = packed_rc + i * stride;
    std::memset(pf, 0, stride * sizeof(uint32_t));
    std::memset(pr, 0, stride * sizeof(uint32_t));
    for (int64_t j = 0; j < len; ++j) {
      int c = code_of(static_cast<unsigned char>(s[j]));
      if (c < 0) {
#pragma omp critical
        if (bad < 0 || i < bad) bad = i;
        break;
      }
      pf[j >> 4] |= static_cast<uint32_t>(c) << (30 - 2 * (j & 15));
      int64_t rj = len - 1 - j;  // rc position of base j
      pr[rj >> 4] |= static_cast<uint32_t>(3 - c) << (30 - 2 * (rj & 15));
    }
  }
  return bad;
}

// Back-compat identity-order entry point (parity oracle callers).
extern "C" int64_t pack_reads(const char* data, const int64_t* offsets,
                              int64_t n, int64_t n_words, uint32_t* packed,
                              uint32_t* packed_rc) {
  return pack_reads_ordered(data, offsets, nullptr, n, n_words, packed,
                            packed_rc);
}

// ---------------------------------------------------------------------------
// FASTA/FASTQ record scanner (native ingest path).
//
// Replicates disco_tpu/io/fasta.py::read_records byte-for-byte (itself a
// replay of the reference parser, src/BuildGraph/src/Dataset.cpp:260-304):
// FASTA records are the nonempty '>'-delimited segments, sequence = bytes
// after the first '\n' with '\n' (only) removed; FASTQ records are strict
// 4-line groups, sequence = line 2 with surrounding whitespace stripped.
// Both upper-cased.
// ---------------------------------------------------------------------------

namespace {

inline char upper(char c) {
  return (c >= 'a' && c <= 'z') ? static_cast<char>(c - 32) : c;
}

// bulk upper-case copy in a branchless form g++ auto-vectorizes (the scalar
// per-byte loop caps the scanner at ~70 MB/s; this runs at memory speed)
inline void copy_upper_bulk(const char* src, char* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const unsigned char c = static_cast<unsigned char>(src[i]);
    const unsigned char low = (c >= 'a') & (c <= 'z');
    dst[i] = static_cast<char>(c - (low << 5));
  }
}

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

}  // namespace

namespace {

// position just past the next '\n' (or size at EOF)
inline int64_t skip_line(const char* data, int64_t i, int64_t size) {
  const char* p = static_cast<const char*>(
      std::memchr(data + i, '\n', static_cast<size_t>(size - i)));
  return p ? (p - data) + 1 : size;
}

}  // namespace

// pass 1: record count. Returns -1 for an unknown leading byte.
extern "C" int64_t seq_scan_count(const char* data, int64_t size) {
  if (size == 0) return 0;
  if (data[0] == '>') {
    int64_t n = 0, i = 1;
    for (;;) {
      const char* p = static_cast<const char*>(
          std::memchr(data + i, '>', static_cast<size_t>(size - i)));
      const int64_t end = p ? p - data : size;
      if (end > i) ++n;
      if (!p) break;
      i = end + 1;
    }
    return n;
  }
  if (data[0] == '@') {
    int64_t i = skip_line(data, 0, size);  // header line
    int64_t n = 0;
    while (i < size) {
      ++n;  // seq line (possibly empty — python readline yields "\n")
      i = skip_line(data, i, size);        // seq
      if (i < size) i = skip_line(data, i, size);  // '+'
      if (i < size) i = skip_line(data, i, size);  // quals
      if (i >= size) break;  // EOF at next header -> stop
      i = skip_line(data, i, size);        // header
    }
    return n;
  }
  return -1;
}

// pass 2: write upper-cased sequence bytes to seq_out and record boundaries
// to offsets (n_cap entries beyond offsets[0]=0).  Returns total sequence
// bytes, or -1 if either buffer capacity would be exceeded — the mmap'd
// pages can re-fault from a file that changed between the count and fill
// passes, so the capacities measured by pass 1 must be enforced here, not
// merely asserted afterwards in Python.
extern "C" int64_t seq_scan_fill(const char* data, int64_t size,
                                 char* seq_out, int64_t cap,
                                 int64_t* offsets, int64_t n_cap) {
  int64_t w = 0, r = 0;
  offsets[0] = 0;
  if (size == 0) return 0;
  bool overflow = false;
  const auto copy_upper = [&](int64_t from, int64_t to) {
    if (w + (to - from) > cap) { overflow = true; return; }
    copy_upper_bulk(data + from, seq_out + w, to - from);
    w += to - from;
  };
  if (data[0] == '>') {
    int64_t i = 1;
    for (;;) {
      const char* gp = static_cast<const char*>(
          std::memchr(data + i, '>', static_cast<size_t>(size - i)));
      const int64_t end = gp ? gp - data : size;
      if (end > i) {
        const char* np = static_cast<const char*>(
            std::memchr(data + i, '\n', static_cast<size_t>(end - i)));
        if (np) {
          // copy sequence lines, dropping only '\n' (a '\r' survives and
          // fails QC, exactly like the python reader)
          int64_t p = (np - data) + 1;
          while (p < end) {
            const char* nl = static_cast<const char*>(
                std::memchr(data + p, '\n', static_cast<size_t>(end - p)));
            const int64_t le = nl ? nl - data : end;
            copy_upper(p, le);
            if (overflow) return -1;
            p = le + 1;
          }
        }
        if (r + 1 > n_cap) return -1;
        offsets[++r] = w;
      }
      if (!gp) break;
      i = end + 1;
    }
    return w;
  }
  // FASTQ
  int64_t i = skip_line(data, 0, size);
  while (i < size) {
    int64_t s = i;
    i = skip_line(data, i, size);
    int64_t e = (i < size || data[size - 1] == '\n') ? i - 1 : i;
    while (s < e && is_space(data[s])) ++s;       // python str.strip()
    while (e > s && is_space(data[e - 1])) --e;
    copy_upper(s, e);
    if (overflow || r + 1 > n_cap) return -1;
    offsets[++r] = w;
    if (i < size) i = skip_line(data, i, size);  // '+'
    if (i < size) i = skip_line(data, i, size);  // quals
    if (i >= size) break;
    i = skip_line(data, i, size);                // next header
  }
  return w;
}

// ---------------------------------------------------------------------------
// Streaming file-backed scan: mmap + MADV_DONTNEED so the raw file never
// occupies process-anonymous memory and its resident pages are released
// between the two passes — at metagenome scale the in-memory raw buffer +
// worst-case output buffer of the buffer API was the largest ingest
// transient (BASELINE.md round-3 memory table).  Byte semantics identical
// to seq_scan_count/seq_scan_fill.
// ---------------------------------------------------------------------------
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct ScanFile {
  int fd = -1;
  const char* map = nullptr;
  int64_t size = 0;
};

// windowed MADV_DONTNEED during a sequential scan, so the PEAK resident
// set stays at one window instead of the whole file (peak RSS is what
// the memory telemetry — and any parent accounting — sees).  Only ever
// armed for file-backed mappings: DONTNEED would ZERO anonymous memory.
struct ScanAdvisor {
  const char* base = nullptr;
  int64_t done = 0;
  static constexpr int64_t kWindow = 64 << 20;
  void maybe(int64_t pos) {
    if (base && pos - done >= 2 * kWindow) {
      int64_t upto = (pos - kWindow) & ~static_cast<int64_t>(4095);
      if (upto > done) {
        madvise(const_cast<char*>(base) + done,
                static_cast<size_t>(upto - done), MADV_DONTNEED);
        done = upto;
      }
    }
  }
};

// counting pass that also totals sequence bytes, so the extract pass can
// write into an exactly-sized buffer.  Returns record count, -1 on an
// unknown leading byte.
int64_t count_and_total(const char* data, int64_t size, int64_t* total_seq,
                        int64_t* offsets = nullptr,
                        const char* madv_base = nullptr,
                        int64_t* rec_pos = nullptr) {
  int64_t total = 0;
  int64_t n = 0;
  ScanAdvisor adv;
  adv.base = madv_base;
  if (offsets) offsets[0] = 0;
  if (size != 0 && data[0] == '>') {
    int64_t i = 1;
    for (;;) {
      adv.maybe(i);
      const char* gp = static_cast<const char*>(
          std::memchr(data + i, '>', static_cast<size_t>(size - i)));
      const int64_t end = gp ? gp - data : size;
      if (end > i) {
        if (rec_pos) rec_pos[n] = i - 1;  // the '>' byte
        ++n;
        const char* np = static_cast<const char*>(
            std::memchr(data + i, '\n', static_cast<size_t>(end - i)));
        if (np) {
          int64_t p = (np - data) + 1;
          while (p < end) {
            const char* nl = static_cast<const char*>(
                std::memchr(data + p, '\n', static_cast<size_t>(end - p)));
            const int64_t le = nl ? nl - data : end;
            total += le - p;
            p = le + 1;
          }
        }
        if (offsets) offsets[n] = total;
      }
      if (!gp) break;
      i = end + 1;
    }
    *total_seq = total;
    return n;
  }
  if (size != 0 && data[0] == '@') {
    int64_t hdr = 0;
    int64_t i = skip_line(data, 0, size);
    while (i < size) {
      adv.maybe(i);
      if (rec_pos) rec_pos[n] = hdr;
      int64_t st = i;
      i = skip_line(data, i, size);
      int64_t e = (i < size || data[size - 1] == '\n') ? i - 1 : i;
      while (st < e && is_space(data[st])) ++st;
      while (e > st && is_space(data[e - 1])) --e;
      total += e - st;
      ++n;
      if (offsets) offsets[n] = total;
      if (i < size) i = skip_line(data, i, size);
      if (i < size) i = skip_line(data, i, size);
      if (i >= size) break;
      hdr = i;
      i = skip_line(data, i, size);
    }
    *total_seq = total;
    return n;
  }
  *total_seq = 0;
  return size == 0 ? 0 : -1;
}

}  // namespace

extern "C" void* seq_scan_open(const char* path, int64_t* n_records,
                               int64_t* total_seq) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* sf = new ScanFile;
  sf->fd = fd;
  sf->size = static_cast<int64_t>(st.st_size);
  if (sf->size > 0) {
    void* m = mmap(nullptr, static_cast<size_t>(sf->size), PROT_READ,
                   MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      close(fd);
      delete sf;
      return nullptr;
    }
    sf->map = static_cast<const char*>(m);
    madvise(m, static_cast<size_t>(sf->size), MADV_SEQUENTIAL);
  }
  *n_records = count_and_total(sf->map, sf->size, total_seq, nullptr,
                               sf->map);
  if (sf->size > 0)
    madvise(const_cast<char*>(sf->map), static_cast<size_t>(sf->size),
            MADV_DONTNEED);
  if (*n_records < 0) {
    if (sf->map)
      munmap(const_cast<char*>(sf->map), static_cast<size_t>(sf->size));
    close(fd);
    delete sf;
    return nullptr;
  }
  return sf;
}

// lengths-only: rewalk to fill the per-record sequence-length boundaries
// (offsets[i+1]-offsets[i] = record i's sequence length), then close the
// handle without materializing any sequence bytes (the simplify DataSet
// loads lengths only, reference: src/SimplifyGraph/src/DataSet.cpp).
extern "C" void seq_scan_offsets_close(void* handle, int64_t* offsets) {
  auto* sf = static_cast<ScanFile*>(handle);
  int64_t tot = 0;
  count_and_total(sf->map, sf->size, &tot, offsets, sf->map);
  if (sf->map)
    munmap(const_cast<char*>(sf->map), static_cast<size_t>(sf->size));
  close(sf->fd);
  delete sf;
}

// fill pass into an exactly total_seq-sized buffer; closes the handle.
// cap / n_cap are the pass-1 measurements: exceeded = file changed = -1.
extern "C" int64_t seq_scan_extract(void* handle, char* seq_out, int64_t cap,
                                    int64_t* offsets, int64_t n_cap) {
  auto* sf = static_cast<ScanFile*>(handle);
  const int64_t w =
      seq_scan_fill(sf->map, sf->size, seq_out, cap, offsets, n_cap);
  if (sf->map)
    munmap(const_cast<char*>(sf->map), static_cast<size_t>(sf->size));
  close(sf->fd);
  delete sf;
  return w;
}


// ---------------------------------------------------------------------------
// Windowed record extraction: parse records [lo, hi) of an open scan
// handle without materializing the whole-file sequence blob (the contig
// streamer previously held an ~file-sized blob; the reference streams
// record by record, OverlapGraph.cpp:2148-2243).
// ---------------------------------------------------------------------------

// record start FILE positions (n entries) for an open handle
extern "C" void seq_scan_record_pos(void* handle, int64_t* rec_pos) {
  auto* sf = static_cast<ScanFile*>(handle);
  int64_t tot = 0;
  count_and_total(sf->map, sf->size, &tot, nullptr, sf->map, rec_pos);
}

// extract records [lo, hi): fills seq_out (cap bytes) + offsets
// (hi-lo+1 entries); file_lo/file_hi are rec_pos[lo] / rec_pos[hi] (or
// size).  Returns total bytes or -1 on capacity overflow.  The consumed
// file range is MADV_DONTNEED'd afterwards so sequential window sweeps
// keep one window resident.
extern "C" int64_t seq_scan_extract_window(void* handle, int64_t file_lo,
                                           int64_t file_hi, char* seq_out,
                                           int64_t cap, int64_t* offsets,
                                           int64_t n_cap) {
  auto* sf = static_cast<ScanFile*>(handle);
  const int64_t w = seq_scan_fill(sf->map + file_lo, file_hi - file_lo,
                                  seq_out, cap, offsets, n_cap);
  const int64_t page_lo = file_lo & ~static_cast<int64_t>(4095);
  madvise(const_cast<char*>(sf->map) + page_lo,
          static_cast<size_t>(file_hi - page_lo), MADV_DONTNEED);
  return w;
}

extern "C" void seq_scan_close(void* handle) {
  auto* sf = static_cast<ScanFile*>(handle);
  if (sf->map)
    munmap(const_cast<char*>(sf->map), static_cast<size_t>(sf->size));
  close(sf->fd);
  delete sf;
}
