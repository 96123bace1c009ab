// Native sequential replay of the reference's graph-construction traversal
// (chunked BFS + Myers transitive reduction + parGraph emission).
//
// Exact behavioral port of disco_tpu/buildg/replay.py::build_graph_replay
// (itself a replay of reference src/BuildGraph/src/OverlapGraph.cpp:100-325,
// 631-678, 687-761, 790-907 with one thread).  The Python implementation is
// kept as the parity oracle; this one exists because the replay is the
// second-hottest host stage after candidate verification.
//
// Edge-list sorting uses std::sort with an offset-only comparator — the
// reference sorts with libstdc++ introsort (OverlapGraph.cpp:676), whose
// (unstable) tie order depends only on comparison outcomes and element
// count, so this reproduces it exactly.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

namespace {

constexpr int MAX_EDGE_PER_KMER = 4;  // reference: Common.h:62

// node states (reference: OverlapGraph.h nodeType)
constexpr int8_t NOT_EXPLORED = -1;
constexpr int8_t EXPLORED = 0;
constexpr int8_t MARKED = 1;
constexpr int8_t REMOVED = 2;
constexpr int8_t WRITTEN = 3;

const int EDGE_ORIENT[4] = {3, 0, 2, 1};  // OverlapGraph.cpp:660-666
const int TWIN_ORIENT[4] = {3, 1, 2, 0};  // OverlapGraph.cpp:770-784

// compact edge record: 20 bytes, addressed by pool index (int32) so the
// pool vector may relocate as it grows; read IDs and offsets fit int32
// (reads are <2^31 and offsets bounded by read length)
struct Edge {
  int32_t src, dst;
  int32_t offset;
  int32_t twin;  // pool index of the twin edge
  int8_t orient;
  int8_t trans;
};

struct Replayer {
  // inputs
  int64_t n, k, wpgs;
  const int64_t* starts;  // (n+1,) hit-group bounds, group of read r (1-based)
                          // = [starts[r-1], starts[r])
  const int16_t* ej;
  const int32_t* er2;   // 1-based
  const int8_t* eo;
  const int32_t* lens;  // 0-based
  const int64_t* fidx;  // 0-based
  uint8_t* all_marked;  // (n+1,), mutated

  // per-component state (stamp-free: reset via touched list)
  std::vector<int8_t> explored;           // (n+1,) node state
  std::vector<uint8_t> in_adj;            // (n+1,)
  std::vector<std::vector<int32_t>> adj;  // (n+1,) pool indices
  std::vector<int64_t> touched;           // nodes with adj entries
  std::vector<int32_t> inserted_stamp;    // (n+1,) insert_all_edges dedupe
  int32_t stamp = 0;
  std::vector<int32_t> marked_stamp;      // (n+1,) mark_transitive presence
  std::vector<int8_t> marked_val;         // (n+1,) 0=INPLAY 1=ELIMINATED
  std::vector<Edge> pool;

  int64_t start_read = 1;      // resume point (reference: _startRead.txt)
  std::string out;
  std::string start_lines;     // one line per chunk: its start read ID
  std::vector<int64_t> chunk_ends;  // byte offset of `out` after each flush

  void ensure_adj(int64_t r) {
    if (!in_adj[r]) {
      in_adj[r] = 1;
      adj[r].clear();
      touched.push_back(r);
    }
  }

  int64_t overlap_len(int32_t ho, int64_t j, int64_t len1) const {
    return (ho == 0 || ho == 2) ? len1 - j : k + j;
  }

  void insert_all_edges(int64_t r1) {
    const int32_t len1 = lens[r1 - 1];
    ensure_adj(r1);
    ++stamp;
    int64_t cur_j = -1;
    int ctr = 0;
    for (int64_t idx = starts[r1 - 1]; idx < starts[r1]; ++idx) {
      const int64_t j = ej[idx];
      if (j != cur_j) {
        cur_j = j;
        ctr = 0;
      }
      if (ctr >= MAX_EDGE_PER_KMER) continue;
      const int32_t r2 = er2[idx];
      if (explored[r2] != NOT_EXPLORED) continue;
      if (inserted_stamp[r2] == stamp) continue;
      const int32_t ho = eo[idx];
      const int32_t len2 = lens[r2 - 1];
      const int32_t ovl = static_cast<int32_t>(overlap_len(ho, j, len1));
      const int8_t orient = static_cast<int8_t>(EDGE_ORIENT[ho]);
      const int32_t offset = len1 - ovl;
      const int32_t ei = static_cast<int32_t>(pool.size());
      pool.push_back(Edge{static_cast<int32_t>(r1), r2, offset, ei + 1,
                          orient, 0});
      pool.push_back(Edge{r2, static_cast<int32_t>(r1),
                          len2 + offset - len1, ei,
                          static_cast<int8_t>(TWIN_ORIENT[orient]), 0});
      adj[r1].push_back(ei);
      ensure_adj(r2);
      adj[r2].push_back(ei + 1);
      inserted_stamp[r2] = stamp;
      ++ctr;
    }
    auto& lst = adj[r1];
    if (!lst.empty()) {
      const Edge* base = pool.data();
      std::sort(lst.begin(), lst.end(),
                [base](int32_t a, int32_t b) {
                  return base[a].offset < base[b].offset;
                });
    }
  }

  void mark_transitive(int64_t r) {
    ++stamp;  // reuse the stamp counter for the marked map too
    auto& lst = adj[r];
    Edge* base = pool.data();
    for (int32_t ei : lst) {
      const int32_t d = base[ei].dst;
      if (marked_stamp[d] != stamp) {
        marked_stamp[d] = stamp;
        marked_val[d] = 0;  // INPLAY
      }
    }
    for (int32_t ei : lst) {
      const Edge& e = base[ei];
      const int32_t r2 = e.dst;
      if (marked_val[r2] == 0 && marked_stamp[r2] == stamp) {
        for (int32_t ei2 : adj[r2]) {
          const Edge& e2 = base[ei2];
          const int32_t r3 = e2.dst;
          if (marked_stamp[r3] == stamp && marked_val[r3] == 0) {
            const int t1 = e.orient, t2 = e2.orient;
            if (((t1 == 0 || t1 == 2) && (t2 == 0 || t2 == 1)) ||
                ((t1 == 1 || t1 == 3) && (t2 == 2 || t2 == 3))) {
              marked_val[r3] = 1;  // ELIMINATED
            }
          }
        }
      }
    }
    for (int32_t ei : lst) {
      Edge& e = base[ei];
      if (marked_stamp[e.dst] == stamp && marked_val[e.dst] == 1) {
        e.trans = 1;
        base[e.twin].trans = 1;
      }
    }
  }

  void delete_twin(int32_t twin) {
    auto& l2 = adj[pool[twin].src];
    for (size_t i = 0; i < l2.size(); ++i) {
      if (l2[i] == twin) {
        l2[i] = l2.back();
        l2.pop_back();
        break;
      }
    }
  }

  void remove_transitive(int64_t r) {
    auto& lst = adj[r];
    for (size_t i = 0; i < lst.size(); ++i) {
      if (pool[lst[i]].trans) delete_twin(pool[lst[i]].twin);
    }
    size_t w = 0;
    for (size_t i = 0; i < lst.size(); ++i) {
      if (!pool[lst[i]].trans) lst[w++] = lst[i];
    }
    lst.resize(w);
  }

  void emit(int64_t f1, int64_t f2, int32_t orient, int64_t ovl,
            int64_t src_len, int64_t offset, int64_t dst_len, int flag) {
    char buf[192];
    const int len = std::snprintf(
        buf, sizeof buf,
        "%lld\t%lld\t%d,%lld,0,0,%lld,%lld,%lld,%lld,0,%lld,NA,%d\n",
        (long long)f1, (long long)f2, orient, (long long)ovl,
        (long long)src_len, (long long)offset, (long long)(src_len - 1),
        (long long)dst_len, (long long)(ovl - 1), flag);
    out.append(buf, len);
  }

  void save_par_graph() {
    std::vector<int64_t> keys;
    keys.reserve(touched.size());
    for (int64_t r : touched) {
      if (in_adj[r]) keys.push_back(r);
    }
    std::sort(keys.begin(), keys.end());
    for (int64_t rid : keys) {
      if (!in_adj[rid]) continue;  // deleted by an earlier iteration? (py:
                                   // snapshot keys, .get returns None only
                                   // after del — mirror with in_adj)
      auto& lst = adj[rid];
      if (lst.empty() || explored[rid] == NOT_EXPLORED) continue;
      if (explored[rid] != REMOVED) continue;
      for (size_t idx = 0; idx < lst.size(); ++idx) {
        const Edge& e = pool[lst[idx]];
        const int32_t ti = e.twin;
        const Edge& te = pool[ti];
        const int64_t src = e.src, dst = e.dst;
        if (src < dst) {
          const int64_t src_len = lens[src - 1];
          const int64_t ovl = src_len - e.offset;
          const int flag = (explored[dst] == REMOVED) ? 2 : 0;
          emit(fidx[src - 1], fidx[dst - 1], e.orient, ovl, src_len,
               e.offset, lens[dst - 1], flag);
        } else {
          const int64_t src_len = lens[dst - 1];  // twin's source = e.dst
          const int64_t ovl = src_len - te.offset;
          const int flag = (explored[dst] == REMOVED) ? 2 : 1;
          emit(fidx[dst - 1], fidx[src - 1], te.orient, ovl, src_len,
               te.offset, lens[src - 1], flag);
        }
        delete_twin(ti);
      }
      in_adj[rid] = 0;
      adj[rid].clear();
      explored[rid] = WRITTEN;
    }
  }

  void run() {
    explored.assign(n + 1, NOT_EXPLORED);
    in_adj.assign(n + 1, 0);
    adj.assign(n + 1, {});
    inserted_stamp.assign(n + 1, 0);
    marked_stamp.assign(n + 1, 0);
    marked_val.assign(n + 1, 0);

    // resume from start_read (reference: OverlapGraph.cpp:178-211 loads the
    // last _startRead.txt line; the first chunk re-explores start even if
    // already marked — the `r1 == start` clause below)
    int64_t start = start_read, prev = start_read;
    while (start != 0) {
      start_lines += std::to_string(start);
      start_lines += '\n';
      // fresh component state
      for (int64_t r : touched) {
        in_adj[r] = 0;
        adj[r].clear();
        explored[r] = NOT_EXPLORED;
      }
      touched.clear();
      pool.clear();
      ensure_adj(start);

      std::deque<int64_t> q;
      q.push_back(start);
      int64_t written = 0;
      while (!q.empty() && written < wpgs) {
        const int64_t r1 = q.front();
        q.pop_front();
        const bool was_marked = all_marked[r1] != 0;
        if (!was_marked) all_marked[r1] = 1;
        if (!was_marked || r1 == start) {
          if (explored[r1] == NOT_EXPLORED) {
            insert_all_edges(r1);
            explored[r1] = EXPLORED;
          }
          if (!adj[r1].empty()) {
            if (explored[r1] == EXPLORED) {
              for (size_t i1 = 0; i1 < adj[r1].size(); ++i1) {
                const int64_t r2 = pool[adj[r1][i1]].dst;
                if (explored[r2] == NOT_EXPLORED) {
                  q.push_back(r2);
                  insert_all_edges(r2);
                  explored[r2] = EXPLORED;
                }
              }
              mark_transitive(r1);
              explored[r1] = MARKED;
            }
            if (explored[r1] == MARKED) {
              for (size_t i1 = 0; i1 < adj[r1].size(); ++i1) {
                const int64_t r2 = pool[adj[r1][i1]].dst;
                if (explored[r2] == EXPLORED) {
                  for (size_t i2 = 0; i2 < adj[r2].size(); ++i2) {
                    const int64_t r3 = pool[adj[r2][i2]].dst;
                    if (explored[r3] == NOT_EXPLORED) {
                      q.push_back(r3);
                      insert_all_edges(r3);
                      explored[r3] = EXPLORED;
                    }
                  }
                  mark_transitive(r2);
                  explored[r2] = MARKED;
                }
              }
              remove_transitive(r1);
              explored[r1] = REMOVED;
              ++written;
            }
          }
        }
      }
      save_par_graph();
      chunk_ends.push_back(static_cast<int64_t>(out.size()));
      start = 0;
      for (int64_t i = prev; i <= n; ++i) {
        if (!all_marked[i]) {
          start = prev = i;
          all_marked[i] = 1;
          break;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns a malloc'd buffer with the parGraph text (newline-terminated
// lines); caller frees with replay_free. *out_size receives the byte count.
// start_read: BFS resume point (1 = fresh run).  *start_buf receives a
// malloc'd buffer with the _startRead.txt content (one line per chunk);
// *chunk_offs a malloc'd int64 array of the parGraph byte offset after each
// chunk flush (*n_chunks entries) — the exact kill points for restart tests.
char* graph_replay(int64_t n, int64_t k, int64_t wpgs, const int64_t* starts,
                   const int16_t* ej, const int32_t* er2, const int8_t* eo,
                   const int32_t* lens, const int64_t* fidx,
                   uint8_t* all_marked, int64_t start_read, int64_t* out_size,
                   char** start_buf, int64_t* start_size,
                   int64_t** chunk_offs, int64_t* n_chunks) {
  Replayer rp;
  rp.n = n;
  rp.k = k;
  rp.wpgs = wpgs;
  rp.starts = starts;
  rp.ej = ej;
  rp.er2 = er2;
  rp.eo = eo;
  rp.lens = lens;
  rp.fidx = fidx;
  rp.all_marked = all_marked;
  rp.start_read = start_read;
  rp.run();
  char* buf = static_cast<char*>(std::malloc(rp.out.size() + 1));
  std::memcpy(buf, rp.out.data(), rp.out.size());
  buf[rp.out.size()] = '\0';
  *out_size = static_cast<int64_t>(rp.out.size());
  char* sbuf = static_cast<char*>(std::malloc(rp.start_lines.size() + 1));
  std::memcpy(sbuf, rp.start_lines.data(), rp.start_lines.size());
  sbuf[rp.start_lines.size()] = '\0';
  *start_buf = sbuf;
  *start_size = static_cast<int64_t>(rp.start_lines.size());
  int64_t* offs = static_cast<int64_t*>(
      std::malloc(sizeof(int64_t) * std::max<size_t>(rp.chunk_ends.size(), 1)));
  std::memcpy(offs, rp.chunk_ends.data(),
              sizeof(int64_t) * rp.chunk_ends.size());
  *chunk_offs = offs;
  *n_chunks = static_cast<int64_t>(rp.chunk_ends.size());
  return buf;
}

void replay_free(char* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Edge-eligible hit grouping (replay prep).
//
// Filters the relation down to edge rows whose endpoints are both
// uncontained and compacts the (j, r2, orient) columns, preserving row
// order (rows arrive grouped by r1 ascending).  Replaces a numpy
// boolean-mask + 4x fancy-index + searchsorted sequence that cost more
// than the traversal itself at 46M rows.
// ---------------------------------------------------------------------------

// pass 1: number of kept rows
int64_t edge_group_count(const int32_t* r1, const int32_t* r2,
                         const uint8_t* edge_ok, const uint8_t* contained,
                         int64_t nrows) {
  int64_t total = 0;
#pragma omp parallel for reduction(+ : total) schedule(static)
  for (int64_t i = 0; i < nrows; ++i) {
    if (edge_ok[i] && !contained[r1[i] + 1] && !contained[r2[i] + 1]) ++total;
  }
  return total;
}

// pass 2: compact kept rows (r2 output 1-based) and emit per-read group
// bounds: group of read r (1-based) = [starts[r-1], starts[r])
void edge_group_fill(const int32_t* r1, const int32_t* j, const int32_t* r2,
                     const int8_t* eo, const uint8_t* edge_ok,
                     const uint8_t* contained, int64_t nrows, int64_t n,
                     int16_t* out_j, int32_t* out_r2, int8_t* out_eo,
                     int64_t* starts) {
  const int64_t block = 1 << 20;
  const int64_t n_blocks = (nrows + block - 1) / block;
  std::vector<int64_t> offs(n_blocks + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t end = std::min((b + 1) * block, nrows);
    int64_t c = 0;
    for (int64_t i = b * block; i < end; ++i) {
      if (edge_ok[i] && !contained[r1[i] + 1] && !contained[r2[i] + 1]) ++c;
    }
    offs[b + 1] = c;
  }
  for (int64_t b = 0; b < n_blocks; ++b) offs[b + 1] += offs[b];
  std::vector<int64_t> counts(n + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t end = std::min((b + 1) * block, nrows);
    int64_t w = offs[b];
    for (int64_t i = b * block; i < end; ++i) {
      if (edge_ok[i] && !contained[r1[i] + 1] && !contained[r2[i] + 1]) {
        out_j[w] = static_cast<int16_t>(j[i]);
        out_r2[w] = r2[i] + 1;
        out_eo[w] = eo[i];
#pragma omp atomic
        ++counts[r1[i] + 1];
        ++w;
      }
    }
  }
  starts[0] = 0;
  for (int64_t r = 1; r <= n; ++r) starts[r] = starts[r - 1] + counts[r];
}

}  // extern "C"
