// The port's traversal replay: the reference's graph-construction walk
// (chunked BFS, Myers transitive reduction, parGraph writer) laid out for
// the host's caches.
//
// It makes the same decisions in the same order as native/src/replay.cpp
// (the JAX package's copy, kept built as the parity oracle) and
// buildg/replay.py::build_graph_replay, and writes the same bytes
// (reference: src/BuildGraph/src/OverlapGraph.cpp:100-325, 631-678,
// 687-761, 790-907 with one thread).  What differs is where the state
// lives:
//
// - a chunk gives each read it touches a dense slot, found through a small
//   hash map of the chunk's reads.  The read's state in the chunk (node
//   state, stamp, mark value, read ID, length) is one 16-byte record of
//   the slot, and its adjacency list the slot's list; both are reused from
//   chunk to chunk, so that nothing is indexed by read ID;
// - an adjacency entry holds the destination's slot and the edge's
//   offset, orientation and transitive mark, so the walk never leaves the
//   lists for the edge.  Of an edge the pool keeps only its position in
//   its holder's list, which makes deleting a twin O(1); the
//   swap-with-last rule is unchanged, so list orders are;
// - insert_all_edges sorts the entries in place with the offset-only
//   comparator: libstdc++'s introsort makes the same comparisons as over
//   pool indices, and leaves the same tie order.  A row's entries are
//   written whatever its tests give and counted only where they pass;
// - one stamp serves the insertion's dedupe and the marking's presence
//   test: every call takes a fresh value, and neither runs inside the
//   other;
// - the writer records each parGraph line as numbers (a twin's offset and
//   orientation follow from its edge's); replay_format prints them after
//   the walk, in parallel.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
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

const int8_t EDGE_ORIENT[4] = {3, 0, 2, 1};  // OverlapGraph.cpp:660-666
const int8_t TWIN_ORIENT[4] = {3, 1, 2, 0};  // OverlapGraph.cpp:770-784

// an adjacency entry: the destination's slot, the edge (its twin is the
// edge ^ 1), and the edge's offset, orientation and transitive mark
struct Entry {
  int32_t slot;
  int32_t edge;
  int32_t offset;
  int8_t orient;
  int8_t trans;
  int16_t pad;
};

// an adjacency list: a vector of entries whose capacity the walk tops up
// before it appends, so that an append can be undone by not counting it
struct List {
  Entry* d = nullptr;
  int32_t n = 0, cap = 0;

  void reserve(int64_t need) {
    if (need <= cap) return;
    int64_t c = cap ? cap : 16;
    while (c < need) c *= 2;
    d = static_cast<Entry*>(std::realloc(d, sizeof(Entry) * c));
    if (!d) std::abort();
    cap = static_cast<int32_t>(c);
  }
  size_t size() const { return static_cast<size_t>(n); }
  bool empty() const { return n == 0; }
  Entry& operator[](size_t i) { return d[i]; }
  const Entry* begin() const { return d; }
  const Entry* end() const { return d + n; }
  Entry* begin() { return d; }
  Entry* end() { return d + n; }
};

// a read's state in the chunk
struct Slot {
  int32_t stamp;  // insert_all_edges: inserted; mark_transitive: in play
  int8_t explored;
  int8_t mval;  // 0 = INPLAY, 1 = ELIMINATED
  int16_t pad;
  int32_t read;  // 1-based read ID
  int32_t len;
};

// the chunk's map from read ID to slot: open addressing, linear probing
struct Bucket {
  int32_t read;  // 0: empty
  int32_t slot;
};

// a parGraph line as numbers: reads a (source) and b, the edge's offset
// from a, its orientation and the mark flag
struct Line {
  int32_t a, b, offset;
  int8_t orient, flag;
};

struct Walk {
  // inputs
  int64_t n, k, wpgs;
  const int64_t* starts;  // group of read r (1-based) = [starts[r-1], starts[r])
  const int16_t* ej;
  const int32_t* er2;  // 1-based
  const int8_t* eo;
  const int32_t* lens;  // 0-based
  uint8_t* all_marked;  // (n+1,), mutated

  std::vector<Bucket> table;
  uint32_t mask = 0;
  int shift = 0;  // the map's capacity is 2^(32 - shift)
  std::vector<Slot> slots;
  std::vector<uint32_t> bucket_of;  // by slot
  std::vector<List> lists;  // by slot; capacity kept
  int32_t n_slots = 0;
  int32_t stamp = 0;
  std::vector<int32_t> pos;  // by edge: its index in its holder's list
  int32_t n_edges = 0;       // edges in the chunk's pool
  std::vector<int32_t> queue;
  std::vector<uint64_t> keys;

  int64_t start_read = 1;
  std::string start_lines;       // one line per chunk: its start read ID
  std::vector<Line> lines;
  std::vector<int64_t> chunk_lines;  // lines.size() after each flush
  int64_t inserts = 0, edges = 0;

  uint32_t home(int32_t r) const {
    return static_cast<uint32_t>(r) * 2654435769u >> shift;
  }

  // the slot of read r, or -1 - (the empty bucket where it would go)
  int32_t find(int32_t r) const {
    uint32_t b = home(r);
    while (true) {
      const Bucket& bk = table[b];
      if (bk.read == r) return bk.slot;
      if (bk.read == 0) return -1 - static_cast<int32_t>(b);
      b = (b + 1) & mask;
    }
  }

  // room in the map for `more` new reads at a load of at most one half
  void reserve_map(int64_t more) {
    const int64_t need = 2 * (n_slots + more);
    if (!table.empty() && need <= static_cast<int64_t>(table.size())) return;
    size_t cap = table.empty() ? 1024 : table.size();
    while (static_cast<int64_t>(cap) < need) cap *= 2;
    table.assign(cap, Bucket{0, 0});
    mask = static_cast<uint32_t>(cap - 1);
    shift = 32 - __builtin_ctzll(cap);
    for (int32_t s = 0; s < n_slots; ++s) {
      const uint32_t b = static_cast<uint32_t>(-1 - find(slots[s].read));
      table[b] = Bucket{slots[s].read, s};
      bucket_of[s] = b;
    }
  }

  // a new slot for read r, whose empty bucket find() gave
  int32_t add(int32_t r, int32_t missing) {
    const int32_t s = n_slots++;
    if (static_cast<size_t>(s) == slots.size()) {
      slots.emplace_back();
      bucket_of.emplace_back();
      lists.emplace_back();
    }
    const uint32_t b = static_cast<uint32_t>(-1 - missing);
    table[b] = Bucket{r, s};
    bucket_of[s] = b;
    slots[s] = Slot{0, NOT_EXPLORED, 0, 0, r, lens[r - 1]};
    return s;
  }

  void reset() {
    for (int32_t s = 0; s < n_slots; ++s) {
      table[bucket_of[s]].read = 0;
      lists[s].n = 0;
    }
    n_slots = 0;
    n_edges = 0;
  }

  void insert_all_edges(int32_t s1) {
    ++inserts;
    const int64_t r1 = slots[s1].read;
    const int32_t len1 = slots[s1].len;
    const int64_t begin = starts[r1 - 1], end = starts[r1];
    reserve_map(end - begin);
    lists[s1].reserve(lists[s1].n + 2 * (end - begin));
    if (static_cast<size_t>(n_edges + 2 * (end - begin)) > pos.size()) {
      pos.resize(std::max(2 * pos.size(),
                          static_cast<size_t>(n_edges + 2 * (end - begin))));
    }
    ++stamp;
    // a row's edge is written whatever the row's tests give, and kept
    // (counted) only where they pass: no branch on them
    int64_t cur_j = -1;
    int ctr = 0;
    for (int64_t idx = begin; idx < end; ++idx) {
      const int64_t j = ej[idx];
      ctr = j == cur_j ? ctr : 0;
      cur_j = j;
      if (ctr >= MAX_EDGE_PER_KMER) continue;
      const int32_t r2 = er2[idx];
      int32_t s2 = find(r2);
      int take = 1;
      if (s2 >= 0) {
        const Slot& sl = slots[s2];
        take = (sl.explored == NOT_EXPLORED) & (sl.stamp != stamp);
      } else {
        s2 = add(r2, s2);
      }
      const int ho = eo[idx];
      Slot& d2 = slots[s2];
      const int32_t ovl = static_cast<int32_t>(
          (ho == 0 || ho == 2) ? len1 - j : k + j);
      const int8_t orient = EDGE_ORIENT[ho];
      const int32_t offset = len1 - ovl;
      const int32_t ei = n_edges;
      List& l1 = lists[s1];
      l1.d[l1.n] = Entry{s2, ei, offset, orient, 0, 0};
      l1.n += take;
      List& l2 = lists[s2];  // l1 itself for an overlap of a read with itself
      if (l2.n == l2.cap) l2.reserve(l2.n + 1);
      pos[ei + 1] = l2.n;
      l2.d[l2.n] = Entry{s1, ei + 1, d2.len + offset - len1,
                         TWIN_ORIENT[orient], 0, 0};
      l2.n += take;
      n_edges += 2 * take;
      d2.stamp = take ? stamp : d2.stamp;
      ctr += take;
      edges += take;
    }
    List& lst = lists[s1];
    std::sort(lst.begin(), lst.end(), [](const Entry& a, const Entry& b) {
      return a.offset < b.offset;
    });
    for (size_t i = 0; i < lst.size(); ++i) {
      pos[lst[i].edge] = static_cast<int32_t>(i);
    }
  }

  void mark_transitive(int32_t s) {
    ++stamp;
    List& lst = lists[s];
    for (const Entry& e : lst) {
      Slot& d = slots[e.slot];
      if (d.stamp != stamp) {
        d.stamp = stamp;
        d.mval = 0;
      }
    }
    for (const Entry& e : lst) {
      const Slot& d = slots[e.slot];
      if (d.mval != 0 || d.stamp != stamp) continue;
      const int t1 = e.orient;
      const bool fwd1 = t1 == 0 || t1 == 2;
      for (const Entry& e2 : lists[e.slot]) {
        Slot& d3 = slots[e2.slot];
        const int t2 = e2.orient;
        const bool elim = fwd1 ? (t2 == 0 || t2 == 1) : (t2 == 2 || t2 == 3);
        d3.mval |= static_cast<int8_t>((d3.stamp == stamp) & elim);
      }
    }
    for (Entry& e : lst) {
      const Slot& d = slots[e.slot];
      if (d.stamp == stamp && d.mval == 1) {
        e.trans = 1;
        List& l2 = lists[e.slot];
        const int32_t p = pos[e.edge ^ 1];
        if (p < l2.n && l2[p].edge == (e.edge ^ 1)) {
          l2[p].trans = 1;
        }
      }
    }
  }

  // remove edge `tw` from the list of slot `h` if it is there: swap with
  // the last entry, then pop (the reference's delete loop, without its scan)
  void delete_twin(int32_t tw, int32_t h) {
    List& l2 = lists[h];
    const int32_t p = pos[tw];
    if (p < l2.n && l2[p].edge == tw) {
      l2[p] = l2[--l2.n];
      pos[l2[p].edge] = p;
    }
  }

  void remove_transitive(int32_t s) {
    for (size_t i = 0; i < lists[s].size(); ++i) {
      const Entry e = lists[s][i];
      if (e.trans) delete_twin(e.edge ^ 1, e.slot);
    }
    List& lst = lists[s];
    int32_t w = 0;
    for (size_t i = 0; i < lst.size(); ++i) {
      if (!lst[i].trans) {
        pos[lst[i].edge] = w;
        lst[w++] = lst[i];
      }
    }
    lst.n = w;
  }

  void save_par_graph() {
    keys.clear();
    for (int32_t s = 0; s < n_slots; ++s) {
      keys.push_back(static_cast<uint64_t>(slots[s].read) << 32 |
                     static_cast<uint32_t>(s));
    }
    std::sort(keys.begin(), keys.end());
    for (uint64_t key : keys) {
      const int32_t s = static_cast<int32_t>(key & 0xffffffffu);
      if (lists[s].empty() || slots[s].explored != REMOVED) continue;
      const int32_t rid = slots[s].read;
      for (size_t idx = 0; idx < lists[s].size(); ++idx) {
        const Entry e = lists[s][idx];
        const Slot& d = slots[e.slot];
        const bool dst_removed = d.explored == REMOVED;
        if (rid < d.read) {
          lines.push_back(Line{rid, d.read, e.offset, e.orient,
                               static_cast<int8_t>(dst_removed ? 2 : 0)});
        } else {  // the twin's line: its offset and orientation
          lines.push_back(Line{d.read, rid, e.offset + d.len - slots[s].len,
                               TWIN_ORIENT[e.orient],
                               static_cast<int8_t>(dst_removed ? 2 : 1)});
        }
        delete_twin(e.edge ^ 1, e.slot);
      }
      lists[s].n = 0;
      slots[s].explored = WRITTEN;
    }
  }

  void run() {
    reserve_map(0);
    // resume from start_read (reference: OverlapGraph.cpp:178-211 loads
    // the last _startRead.txt line; the first chunk re-explores start even
    // if already marked: the `r1 == start` clause below)
    int64_t start = start_read, prev = start_read;
    while (start != 0) {
      start_lines += std::to_string(start);
      start_lines += '\n';
      reset();
      queue.clear();
      queue.push_back(add(static_cast<int32_t>(start),
                          find(static_cast<int32_t>(start))));
      size_t head = 0;
      int64_t written = 0;
      while (head < queue.size() && written < wpgs) {
        const int32_t s1 = queue[head++];
        const int64_t r1 = slots[s1].read;
        const bool was_marked = all_marked[r1] != 0;
        if (!was_marked) all_marked[r1] = 1;
        if (was_marked && r1 != start) continue;
        if (slots[s1].explored == NOT_EXPLORED) {
          insert_all_edges(s1);
          slots[s1].explored = EXPLORED;
        }
        if (lists[s1].empty()) continue;
        if (slots[s1].explored == EXPLORED) {
          for (size_t i1 = 0; i1 < lists[s1].size(); ++i1) {
            const int32_t s2 = lists[s1][i1].slot;
            if (slots[s2].explored == NOT_EXPLORED) {
              queue.push_back(s2);
              insert_all_edges(s2);
              slots[s2].explored = EXPLORED;
            }
          }
          mark_transitive(s1);
          slots[s1].explored = MARKED;
        }
        if (slots[s1].explored == MARKED) {
          for (size_t i1 = 0; i1 < lists[s1].size(); ++i1) {
            const int32_t s2 = lists[s1][i1].slot;
            if (slots[s2].explored != EXPLORED) continue;
            for (size_t i2 = 0; i2 < lists[s2].size(); ++i2) {
              const int32_t s3 = lists[s2][i2].slot;
              if (slots[s3].explored == NOT_EXPLORED) {
                queue.push_back(s3);
                insert_all_edges(s3);
                slots[s3].explored = EXPLORED;
              }
            }
            mark_transitive(s2);
            slots[s2].explored = MARKED;
          }
          remove_transitive(s1);
          slots[s1].explored = REMOVED;
          ++written;
        }
      }
      save_par_graph();
      chunk_lines.push_back(static_cast<int64_t>(lines.size()));
      start = 0;
      for (int64_t i = prev; i <= n; ++i) {
        if (!all_marked[i]) {
          start = prev = i;
          all_marked[i] = 1;
          break;
        }
      }
    }
    reset();
  }
};

int n_digits(uint64_t v) {
  int d = 1;
  while (v >= 10) {
    v /= 10;
    ++d;
  }
  return d;
}

int text_len(int64_t v) {
  const uint64_t u = static_cast<uint64_t>(v);
  return v < 0 ? 1 + n_digits(0 - u) : n_digits(u);
}

char* put_int(char* p, int64_t v) {
  uint64_t u = static_cast<uint64_t>(v);
  if (v < 0) {
    *p++ = '-';
    u = 0 - u;
  }
  char tmp[20];
  int i = 0;
  do {
    tmp[i++] = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  while (i) *p++ = tmp[--i];
  return p;
}

// the fields of a line, in the order printed:
// f1 \t f2 \t orient,ovl,0,0,src_len,offset,src_len-1,dst_len,0,ovl-1,NA,flag
struct Fields {
  int64_t f1, f2, ovl, src_len, dst_len;
};

Fields fields(const Line& l, const int64_t* fidx, const int32_t* lens) {
  const int64_t src_len = lens[l.a - 1];
  return Fields{fidx[l.a - 1], fidx[l.b - 1], src_len - l.offset, src_len,
                lens[l.b - 1]};
}

int64_t line_len(const Line& l, const Fields& f) {
  // 2 tabs, 11 commas, "0" x 3, "NA", the newline, one digit of orient
  // and of flag
  return 2 + 11 + 3 + 2 + 1 + 2 + text_len(f.f1) + text_len(f.f2) +
         text_len(f.ovl) + text_len(f.src_len) + text_len(l.offset) +
         text_len(f.src_len - 1) + text_len(f.dst_len) + text_len(f.ovl - 1);
}

char* put_line(char* p, const Line& l, const Fields& f) {
  p = put_int(p, f.f1);
  *p++ = '\t';
  p = put_int(p, f.f2);
  *p++ = '\t';
  *p++ = static_cast<char>('0' + l.orient);
  *p++ = ',';
  p = put_int(p, f.ovl);
  std::memcpy(p, ",0,0,", 5);
  p += 5;
  p = put_int(p, f.src_len);
  *p++ = ',';
  p = put_int(p, l.offset);
  *p++ = ',';
  p = put_int(p, f.src_len - 1);
  *p++ = ',';
  p = put_int(p, f.dst_len);
  std::memcpy(p, ",0,", 3);
  p += 3;
  p = put_int(p, f.ovl - 1);
  std::memcpy(p, ",NA,", 4);
  p += 4;
  *p++ = static_cast<char>('0' + l.flag);
  *p++ = '\n';
  return p;
}

struct Result {
  Walk walk;
  char* text = nullptr;
  int64_t text_size = 0;
  std::vector<int64_t> chunk_ends;
};

}  // namespace

extern "C" {

// The walk: from start_read (1 = a fresh run), marking all_marked as it
// goes.  Returns a handle for replay_format / replay_output / replay_free;
// counts[0..2] receive the calls to insert_all_edges, the edge pairs made
// and the parGraph lines.
void* replay_walk(int64_t n, int64_t k, int64_t wpgs, const int64_t* starts,
                  const int16_t* ej, const int32_t* er2, const int8_t* eo,
                  const int32_t* lens, uint8_t* all_marked,
                  int64_t start_read, int64_t* counts) {
  Result* res = new Result;
  Walk& w = res->walk;
  w.n = n;
  w.k = k;
  w.wpgs = wpgs;
  w.starts = starts;
  w.ej = ej;
  w.er2 = er2;
  w.eo = eo;
  w.lens = lens;
  w.all_marked = all_marked;
  w.start_read = start_read;
  w.run();
  // the walk's own buffers go before the text is made
  std::vector<Bucket>().swap(w.table);
  std::vector<Slot>().swap(w.slots);
  std::vector<uint32_t>().swap(w.bucket_of);
  for (List& l : w.lists) std::free(l.d);
  std::vector<List>().swap(w.lists);
  std::vector<int32_t>().swap(w.pos);
  std::vector<int32_t>().swap(w.queue);
  std::vector<uint64_t>().swap(w.keys);
  counts[0] = w.inserts;
  counts[1] = w.edges;
  counts[2] = static_cast<int64_t>(w.lines.size());
  return res;
}

// Print the walk's lines (fidx, lens: 0-based by read) in parallel into
// the handle's text; returns its byte count.
int64_t replay_format(void* h, const int64_t* fidx, const int32_t* lens) {
  Result* res = static_cast<Result*>(h);
  const std::vector<Line>& lines = res->walk.lines;
  const int64_t nl = static_cast<int64_t>(lines.size());
  std::vector<int64_t> at(nl + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nl; ++i) {
    at[i + 1] = line_len(lines[i], fields(lines[i], fidx, lens));
  }
  for (int64_t i = 0; i < nl; ++i) at[i + 1] += at[i];
  std::free(res->text);
  res->text = static_cast<char*>(std::malloc(at[nl] + 1));
  char* text = res->text;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nl; ++i) {
    put_line(text + at[i], lines[i], fields(lines[i], fidx, lens));
  }
  text[at[nl]] = '\0';
  res->text_size = at[nl];
  res->chunk_ends.clear();
  for (int64_t c : res->walk.chunk_lines) res->chunk_ends.push_back(at[c]);
  return at[nl];
}

// The handle's outputs, owned by it: the parGraph text (after
// replay_format), the _startRead.txt content, and the parGraph byte offset
// after each chunk flush (the valid kill/restart points).
void replay_output(void* h, char** text, char** start_buf,
                   int64_t* start_size, int64_t** chunk_ends,
                   int64_t* n_chunks) {
  Result* res = static_cast<Result*>(h);
  *text = res->text;
  *start_buf = res->walk.start_lines.data();
  *start_size = static_cast<int64_t>(res->walk.start_lines.size());
  *chunk_ends = res->chunk_ends.data();
  *n_chunks = static_cast<int64_t>(res->chunk_ends.size());
}

void replay_free(void* h) {
  Result* res = static_cast<Result*>(h);
  std::free(res->text);
  delete res;
}

}  // extern "C"
