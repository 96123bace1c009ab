// Read -> edge back-index arena (reference: Read::setEdge/delEdge +
// edgeP[]/edgeOriIndex[], src/SimplifyGraph/src/Read.h:31-33,121-128).
//
// Per-read singly linked chains over slot arenas, bulk add/remove per
// edge (one call per _update_read_locations), queries filling caller
// buffers.  Entries carry (addr<<33 | idx<<2 | orient_bit) with the
// edge's allocation serial `addr` standing in for the C++ Edge* — the
// Python side resolves addr -> Edge via a dict.  Append order per read
// is preserved (head/tail), matching the reference's vector push_back
// iteration order, and the reference's delEdge no-match quirk (drop the
// final entry anyway) is replicated.
//
// ~20 B/entry (key int64 + next int32 + free-list reuse) vs ~150 B for
// boxed Python ints + per-read list objects — the top live allocation
// of the simplify phase at metagenome scale.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BackIndex {
  std::vector<int32_t> head, tail;  // per read, -1 = none
  std::vector<int64_t> key;         // addr<<33 | idx<<2 | orient<<1
  std::vector<int32_t> nxt;
  std::vector<int32_t> free_slots;

  explicit BackIndex(int64_t n_reads)
      : head(n_reads + 1, -1), tail(n_reads + 1, -1) {}

  int32_t alloc() {
    if (!free_slots.empty()) {
      int32_t s = free_slots.back();
      free_slots.pop_back();
      return s;
    }
    key.push_back(0);
    nxt.push_back(-1);
    return static_cast<int32_t>(key.size() - 1);
  }

  void add(int64_t rid, int64_t k) {
    int32_t s = alloc();
    key[s] = k;
    nxt[s] = -1;
    int32_t t = tail[rid];
    if (t < 0)
      head[rid] = s;
    else
      nxt[t] = s;
    tail[rid] = s;
  }

  void unlink(int64_t rid, int32_t prev, int32_t s) {
    int32_t nx = nxt[s];
    if (prev < 0)
      head[rid] = nx;
    else
      nxt[prev] = nx;
    if (nx < 0) tail[rid] = prev;
    free_slots.push_back(s);
  }

  void remove(int64_t rid, int64_t k) {
    int32_t s = head[rid];
    if (s < 0) return;
    int32_t prev = -1, last_prev = -1, last = -1;
    while (s >= 0) {
      if (key[s] == k) {
        unlink(rid, prev, s);
        return;
      }
      last_prev = prev;
      last = s;
      prev = s;
      s = nxt[s];
    }
    // reference delEdge with no match decrements the count anyway,
    // dropping the final entry (Read.cpp delEdge)
    if (last >= 0) unlink(rid, last_prev, last);
  }
};

}  // namespace

extern "C" {

void* backindex_new(int64_t n_reads) { return new BackIndex(n_reads); }

void backindex_free(void* h) { delete static_cast<BackIndex*>(h); }

// bulk register edge `addr`:
// entry i = (rids[i], addr<<33 | (idx0+i)<<2 | ori_bits[i]<<1)
void backindex_add_bulk(void* h, const int32_t* rids, const int8_t* ori_bits,
                        int64_t n, int64_t addr, int64_t idx0) {
  auto* b = static_cast<BackIndex*>(h);
  const int64_t base = addr << 33;
  for (int64_t i = 0; i < n; ++i)
    b->add(rids[i], base | ((idx0 + i) << 2) |
                        (static_cast<int64_t>(ori_bits[i]) << 1));
}

void backindex_remove_bulk(void* h, const int32_t* rids,
                           const int8_t* ori_bits, int64_t n, int64_t addr,
                           int64_t idx0) {
  auto* b = static_cast<BackIndex*>(h);
  const int64_t base = addr << 33;
  for (int64_t i = 0; i < n; ++i)
    b->remove(rids[i], base | ((idx0 + i) << 2) |
                           (static_cast<int64_t>(ori_bits[i]) << 1));
}

// fill (addr, idx) pairs for entries of `rid` with the given orient bit.
// Returns count; out_addr/out_idx sized by caller to backindex_count(rid).
int64_t backindex_query(void* h, int64_t rid, int32_t orient_bit,
                        int64_t* out_addr, int64_t* out_idx) {
  auto* b = static_cast<BackIndex*>(h);
  int64_t w = 0;
  for (int32_t s = b->head[rid]; s >= 0; s = b->nxt[s]) {
    int64_t k = b->key[s];
    if (((k >> 1) & 1) == orient_bit) {
      out_addr[w] = k >> 33;
      out_idx[w] = (k >> 2) & 0x7FFFFFFF;
      ++w;
    }
  }
  return w;
}

int64_t backindex_count(void* h, int64_t rid) {
  auto* b = static_cast<BackIndex*>(h);
  int64_t c = 0;
  for (int32_t s = b->head[rid]; s >= 0; s = b->nxt[s]) ++c;
  return c;
}

int32_t backindex_has(void* h, int64_t rid) {
  return static_cast<BackIndex*>(h)->head[rid] >= 0;
}

// zero-copy view of the per-read head array (fixed size: never grows)
int32_t* backindex_head_ptr(void* h) {
  return static_cast<BackIndex*>(h)->head.data();
}

// single-call query into caller buffers of capacity `cap`; returns the
// entry count, or -(count) if cap was too small (caller grows, retries).
int64_t backindex_query_cap(void* h, int64_t rid, int32_t orient_bit,
                            int64_t* out_addr, int64_t* out_idx,
                            int64_t cap) {
  auto* b = static_cast<BackIndex*>(h);
  int64_t w = 0;
  for (int32_t s = b->head[rid]; s >= 0; s = b->nxt[s]) {
    int64_t k = b->key[s];
    if (((k >> 1) & 1) == orient_bit) {
      if (w < cap) {
        out_addr[w] = k >> 33;
        out_idx[w] = (k >> 2) & 0x7FFFFFFF;
      }
      ++w;
    }
  }
  return w <= cap ? w : -w;
}

}  // extern "C"
