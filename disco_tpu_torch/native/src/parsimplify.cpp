// Native `parsimplify`: per-partition contraction + dead-end removal.
//
// Exact behavioral port of disco_tpu/simplify/pargraph.py::parsimplify
// (itself a bit-parity replay of the reference executable, reference:
// src/SimplifyGraph/src/mainParSimplify.cpp:10-21,
// src/SimplifyGraph/src/OverlapGraphSimple.cpp, single-threaded).  The
// Python implementation stays as the parity oracle; this one exists
// because the parsimplify phase dominated fullsimplify wall time.
//
// Parity-critical details mirrored from the oracle:
// - allocation serials with a LIFO free list stand in for C++ heap
//   addresses (`this < m_reverseEdge` loop tie-break at print time);
// - std::sort by (dst<<32 | edgeLength) per node — this IS libstdc++
//   introsort, the exact unstable tie order the oracle replicates;
// - chain extension invalidates but does not remove edges, so list
//   LENGTHS include invalidated edges until the deletion sweep;
// - the chain temp edge is mutated in place (deque push front/back)
//   instead of reallocating per merge — contents and the serial
//   alloc/free sequence are identical, cost drops from O(L^2) to O(L).
//
// Performance structure: node IDs are mapped once to dense SLOTS assigned
// in ascending-ID order, so "std::map iteration order" is just slot order
// and every per-node state (adjacency, marked, consumed, visit stamps) is
// a flat array — no tree or hash walks in the hot loops.  The node set is
// fixed after load (parsimplify never creates new endpoints).
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t MIN_READS_NOT_DEAD_END = 5;  // reference: Config.cpp:42
constexpr int64_t MIN_LEN_NOT_DEAD_END = 500;  // reference: Config.cpp:43

struct Inner {
  uint64_t rid;
  int8_t ori;
  int64_t off;
};

// orientation algebra (reference: Edge.cpp:496-527)
inline bool is_mergeable_o(int o1, int o2) {
  return (o1 & 1) == ((o2 >> 1) & 1);
}
inline int merged_orient(int o1, int o2) { return (o1 & 2) | (o2 & 1); }
inline int twin_orient(int o) {
  return ((o >> 1) ^ 1) | (((o & 1) ^ 1) << 1);
}

struct Alloc {
  int64_t next = 1;
  std::vector<int64_t> free_list;
  int64_t alloc() {
    if (!free_list.empty()) {
      int64_t a = free_list.back();
      free_list.pop_back();
      return a;
    }
    return next++;
  }
  void dealloc(int64_t a) { free_list.push_back(a); }
};

struct PEdge {
  uint64_t src, dst;
  int32_t src_slot, dst_slot;
  int64_t src_len, dst_len;
  int orient;
  int64_t offset;
  std::vector<Inner> inner;
  int64_t inner_sum = 0;  // running sum of inner offsets
  PEdge* twin = nullptr;
  uint8_t flags = 0;  // 1 = NOT_DEAD_END, 2 = LOOP
  bool invalid = false;
  int64_t addr = 0;

  bool is_loop() const { return flags & 2; }
  bool is_not_dead_end() const { return flags & 1; }
  void mark_not_dead_end() {
    flags |= 1;
    twin->flags |= 1;
  }
  int64_t edge_length() const { return offset + dst_len; }
  int64_t last_offset() const {
    return inner.empty() ? offset : offset - inner_sum;
  }
  bool is_smaller() const {
    if (src < dst) return true;
    if (src > dst) return false;
    return addr < twin->addr;
  }
  bool same_as(const PEdge& o) const {
    if (src != o.src || dst != o.dst || offset != o.offset ||
        orient != o.orient)
      return false;
    if (inner.size() != o.inner.size()) return false;
    for (size_t i = 0; i < inner.size(); ++i) {
      if (inner[i].rid != o.inner[i].rid) return false;
    }
    return true;
  }
};

struct RawEdge {  // one parsed input line
  uint64_t src, dst;
  int64_t src_len, dst_len, offset;
  int orient;
  int mark_flag;
};

struct Graph {
  Alloc alloc;
  std::deque<PEdge> pool;  // stable addresses
  std::vector<uint64_t> keys;           // sorted node IDs; slot = index
  std::vector<std::vector<PEdge*>> adj;  // per slot
  std::vector<uint8_t> marked;           // per slot

  int32_t slot_of(uint64_t id) const {  // ids always present by construction
    return static_cast<int32_t>(
        std::lower_bound(keys.begin(), keys.end(), id) - keys.begin());
  }

  PEdge* new_edge(uint64_t src, int32_t src_slot, int64_t src_len,
                  uint64_t dst, int32_t dst_slot, int64_t dst_len, int orient,
                  int64_t offset) {
    pool.push_back(PEdge{});
    PEdge* e = &pool.back();
    e->src = src;
    e->src_slot = src_slot;
    e->src_len = src_len;
    e->dst = dst;
    e->dst_slot = dst_slot;
    e->dst_len = dst_len;
    e->orient = orient;
    e->offset = offset;
    e->flags = (src == dst) ? 2 : 0;
    e->addr = alloc.alloc();
    return e;
  }

  void insert_edge(PEdge* e) {
    adj[e->src_slot].push_back(e);
    adj[e->twin->src_slot].push_back(e->twin);
  }

  void free_pair(PEdge* e) {  // twin freed first (oracle free_pair)
    alloc.dealloc(e->twin->addr);
    alloc.dealloc(e->addr);
  }

  void remove_edge(PEdge* e) {  // order-preserving removal of e and twin
    auto& l1 = adj[e->src_slot];
    l1.erase(std::remove(l1.begin(), l1.end(), e), l1.end());
    auto& l2 = adj[e->twin->src_slot];
    l2.erase(std::remove(l2.begin(), l2.end(), e->twin), l2.end());
    free_pair(e);
  }

  bool exists_edge(const PEdge* e) const {
    for (const PEdge* x : adj[e->src_slot]) {
      if (x->same_as(*e)) return true;
    }
    return false;
  }
};

// merged composite of two PERSISTENT edges (oracle add_edges: fresh
// forward edge allocated first, then reverse; inner lists copied)
PEdge* add_edges(Graph& G, PEdge* e1, PEdge* e2) {
  PEdge* fwd = G.new_edge(e1->src, e1->src_slot, e1->src_len, e2->dst,
                          e2->dst_slot, e2->dst_len,
                          merged_orient(e1->orient, e2->orient),
                          e1->offset + e2->offset);
  fwd->inner.reserve(e1->inner.size() + 1 + e2->inner.size());
  fwd->inner = e1->inner;
  fwd->inner.push_back(Inner{e1->dst, static_cast<int8_t>(e1->orient & 1),
                             e1->last_offset()});
  fwd->inner.insert(fwd->inner.end(), e2->inner.begin(), e2->inner.end());
  fwd->inner_sum = e1->offset + e2->inner_sum;
  PEdge* t1 = e1->twin;
  PEdge* t2 = e2->twin;
  PEdge* rev = G.new_edge(t2->src, t2->src_slot, t2->src_len, t1->dst,
                          t1->dst_slot, t1->dst_len,
                          merged_orient(t2->orient, t1->orient),
                          t2->offset + t1->offset);
  rev->inner.reserve(t2->inner.size() + 1 + t1->inner.size());
  rev->inner = t2->inner;
  rev->inner.push_back(Inner{t2->dst, static_cast<int8_t>(t2->orient & 1),
                             t2->last_offset()});
  rev->inner.insert(rev->inner.end(), t1->inner.begin(), t1->inner.end());
  rev->inner_sum = t2->offset + t1->inner_sum;
  fwd->twin = rev;
  rev->twin = fwd;
  return fwd;
}

// -------------------------------------------------------------------------
// chain temp: the oracle's copy_pair + repeated add_edges/free_pair on a
// local edge, with the deque mutated in place.  The serial alloc/free
// sequence is replayed verbatim so the final composite's addr pair matches.
// -------------------------------------------------------------------------
struct ChainTemp {
  uint64_t src, dst;
  int32_t src_slot, dst_slot;
  int64_t src_len, dst_len;
  int orient, t_orient;
  int64_t offset, t_offset;
  int64_t inner_sum, t_inner_sum;
  std::deque<Inner> inner, t_inner;
  int64_t addr, t_addr;
  bool loop, t_loop;  // LOOP flags (copy_pair copies; merges re-derive)

  void init_from(Graph& G, const PEdge* e) {  // oracle copy_pair
    src = e->src;
    src_slot = e->src_slot;
    src_len = e->src_len;
    dst = e->dst;
    dst_slot = e->dst_slot;
    dst_len = e->dst_len;
    orient = e->orient;
    offset = e->offset;
    inner.assign(e->inner.begin(), e->inner.end());
    inner_sum = e->inner_sum;
    addr = G.alloc.alloc();
    const PEdge* t = e->twin;
    t_orient = t->orient;
    t_offset = t->offset;
    t_inner.assign(t->inner.begin(), t->inner.end());
    t_inner_sum = t->inner_sum;
    t_addr = G.alloc.alloc();
    loop = e->is_loop();
    t_loop = t->is_loop();
  }

  int64_t last_offset() const {
    return inner.empty() ? offset : offset - inner_sum;
  }
  int64_t t_last_offset() const {
    return t_inner.empty() ? t_offset : t_offset - t_inner_sum;
  }

  void bump_serials(Graph& G) {  // tmp = add_edges(...); free_pair(old)
    const int64_t f = G.alloc.alloc();
    const int64_t r = G.alloc.alloc();
    G.alloc.dealloc(t_addr);
    G.alloc.dealloc(addr);
    addr = f;
    t_addr = r;
  }

  // cur = add_edges(cur, nfe)  [forward chain step]
  void extend_forward(Graph& G, const PEdge* nfe) {
    // fwd.inner = cur.inner ++ [(cur.dst, cur.orient&1, cur.last_offset())]
    //             ++ nfe.inner
    inner.push_back(
        Inner{dst, static_cast<int8_t>(orient & 1), last_offset()});
    inner.insert(inner.end(), nfe->inner.begin(), nfe->inner.end());
    const int64_t new_inner_sum = offset + nfe->inner_sum;  // old offset
    // rev.inner = nfe.twin.inner ++ [(nfe.twin.dst, nfe.twin.orient&1,
    //             nfe.twin.last_offset())] ++ cur.twin.inner
    const PEdge* nt = nfe->twin;
    t_inner.push_front(
        Inner{nt->dst, static_cast<int8_t>(nt->orient & 1),
              nt->last_offset()});
    t_inner.insert(t_inner.begin(), nt->inner.begin(), nt->inner.end());
    const int64_t new_t_inner_sum = nt->offset + t_inner_sum;
    // forward fields
    orient = merged_orient(orient, nfe->orient);
    offset = offset + nfe->offset;
    dst = nfe->dst;
    dst_slot = nfe->dst_slot;
    dst_len = nfe->dst_len;
    inner_sum = new_inner_sum;
    // twin fields (rev = merge(nfe.twin, cur.twin): src from nfe.twin)
    t_orient = merged_orient(nt->orient, t_orient);
    t_offset = nt->offset + t_offset;
    t_inner_sum = new_t_inner_sum;
    loop = t_loop = (src == dst);
    bump_serials(G);
  }

  // cur = add_edges(nre, cur)  [backward chain step]
  void extend_backward(Graph& G, const PEdge* nre) {
    // fwd.inner = nre.inner ++ [(nre.dst, nre.orient&1, nre.last_offset())]
    //             ++ cur.inner
    inner.push_front(Inner{nre->dst, static_cast<int8_t>(nre->orient & 1),
                           nre->last_offset()});
    inner.insert(inner.begin(), nre->inner.begin(), nre->inner.end());
    const int64_t new_inner_sum = nre->offset + inner_sum;
    // rev.inner = cur.twin.inner ++ [(cur.twin.dst = cur.src,
    //             cur.twin.orient&1, cur.twin.last_offset())]
    //             ++ nre.twin.inner
    t_inner.push_back(Inner{src, static_cast<int8_t>(t_orient & 1),
                            t_last_offset()});
    const PEdge* nt = nre->twin;
    t_inner.insert(t_inner.end(), nt->inner.begin(), nt->inner.end());
    const int64_t new_t_inner_sum = t_offset + nt->inner_sum;
    // forward fields (fwd = merge(nre, cur): src from nre)
    orient = merged_orient(nre->orient, orient);
    offset = nre->offset + offset;
    src = nre->src;
    src_slot = nre->src_slot;
    src_len = nre->src_len;
    inner_sum = new_inner_sum;
    // twin fields (rev = merge(cur.twin, nre.twin): dst = nre.twin.dst)
    t_orient = merged_orient(t_orient, nt->orient);
    t_offset = t_offset + nt->offset;
    t_inner_sum = new_t_inner_sum;
    loop = t_loop = (src == dst);
    bump_serials(G);
  }
};

// new_edge = add_edges(cur_rev, cur_fwd); free_pair(cur_rev);
// free_pair(cur_fwd)  [final composite]
PEdge* finish_chain(Graph& G, ChainTemp& rev_t, ChainTemp& fwd_t) {
  const Inner mid{rev_t.dst, static_cast<int8_t>(rev_t.orient & 1),
                  rev_t.last_offset()};
  const Inner mid2{fwd_t.src /* fwd_t.twin.dst */,
                   static_cast<int8_t>(fwd_t.t_orient & 1),
                   fwd_t.t_last_offset()};
  PEdge* fwd = G.new_edge(rev_t.src, rev_t.src_slot, rev_t.src_len,
                          fwd_t.dst, fwd_t.dst_slot, fwd_t.dst_len,
                          merged_orient(rev_t.orient, fwd_t.orient),
                          rev_t.offset + fwd_t.offset);
  fwd->inner.reserve(rev_t.inner.size() + 1 + fwd_t.inner.size());
  fwd->inner.assign(rev_t.inner.begin(), rev_t.inner.end());
  fwd->inner.push_back(mid);
  fwd->inner.insert(fwd->inner.end(), fwd_t.inner.begin(),
                    fwd_t.inner.end());
  fwd->inner_sum = rev_t.offset + fwd_t.inner_sum;
  // rev = merge(fwd_t.twin, rev_t.twin); twin.src == fwd.dst invariants
  PEdge* rev = G.new_edge(fwd_t.dst, fwd_t.dst_slot, fwd_t.dst_len,
                          rev_t.src, rev_t.src_slot, rev_t.src_len,
                          merged_orient(fwd_t.t_orient, rev_t.t_orient),
                          fwd_t.t_offset + rev_t.t_offset);
  rev->inner.reserve(fwd_t.t_inner.size() + 1 + rev_t.t_inner.size());
  rev->inner.assign(fwd_t.t_inner.begin(), fwd_t.t_inner.end());
  rev->inner.push_back(mid2);
  rev->inner.insert(rev->inner.end(), rev_t.t_inner.begin(),
                    rev_t.t_inner.end());
  rev->inner_sum = fwd_t.t_offset + rev_t.t_inner_sum;
  fwd->twin = rev;
  rev->twin = fwd;
  // serial bookkeeping: the two new_edge calls above allocated f,r; now
  // free the temps (rev_t then fwd_t, twin first each)
  G.alloc.dealloc(rev_t.t_addr);
  G.alloc.dealloc(rev_t.addr);
  G.alloc.dealloc(fwd_t.t_addr);
  G.alloc.dealloc(fwd_t.addr);
  return fwd;
}

// -------------------------------------------------------------------------
// phases (oracle: pargraph.py)
// -------------------------------------------------------------------------
bool parse_edges(const char* path, int64_t min_ovl,
                 std::vector<RawEdge>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::string buf;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(sz));
  if (sz > 0 && std::fread(&buf[0], 1, static_cast<size_t>(sz), f) !=
                    static_cast<size_t>(sz)) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  const char* p = buf.data();
  const char* end = p + buf.size();
  auto parse_u = [](const char*& q) {
    int64_t v = 0;
    while (*q >= '0' && *q <= '9') v = v * 10 + (*q++ - '0');
    return v;
  };
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* le = nl ? nl : end;
    if (le > p) {
      const char* q = p;
      const uint64_t src = static_cast<uint64_t>(parse_u(q));
      ++q;  // tab
      const uint64_t dst = static_cast<uint64_t>(parse_u(q));
      ++q;  // tab
      const int orient = static_cast<int>(parse_u(q));
      ++q;
      const int64_t ovl_len = parse_u(q);
      ++q;
      parse_u(q);  // props[2]
      ++q;
      parse_u(q);  // props[3]
      ++q;
      const int64_t len1 = parse_u(q);
      ++q;
      const int64_t start1 = parse_u(q);
      ++q;
      parse_u(q);  // props[6]
      ++q;
      const int64_t len2 = parse_u(q);
      ++q;
      parse_u(q);  // props[8]
      ++q;
      parse_u(q);  // props[9]
      ++q;
      // props[10] is "NA"
      int64_t mark_flag = 2;
      while (q < le && *q != ',') ++q;
      if (q < le) {
        ++q;
        mark_flag = parse_u(q);
      }
      if (ovl_len >= min_ovl) {
        out.push_back(RawEdge{src, dst, len1, len2, start1, orient,
                              static_cast<int>(mark_flag)});
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  return true;
}

void build_graph(Graph& G, const std::vector<RawEdge>& raw) {
  G.keys.reserve(raw.size() * 2);
  for (const RawEdge& r : raw) {
    G.keys.push_back(r.src);
    G.keys.push_back(r.dst);
  }
  std::sort(G.keys.begin(), G.keys.end());
  G.keys.erase(std::unique(G.keys.begin(), G.keys.end()), G.keys.end());
  G.adj.resize(G.keys.size());
  G.marked.assign(G.keys.size(), 0);
  for (const RawEdge& r : raw) {
    const int32_t ss = G.slot_of(r.src);
    const int32_t ds = G.slot_of(r.dst);
    // oracle make_twin_pair: forward edge allocated first
    PEdge* fwd = G.new_edge(r.src, ss, r.src_len, r.dst, ds, r.dst_len,
                            r.orient, r.offset);
    PEdge* rev = G.new_edge(r.dst, ds, r.dst_len, r.src, ss, r.src_len,
                            twin_orient(r.orient),
                            r.dst_len + r.offset - r.src_len);
    fwd->twin = rev;
    rev->twin = fwd;
    G.insert_edge(fwd);
    if (r.mark_flag == 0) {
      G.marked[ss] = 1;
    } else if (r.mark_flag == 1) {
      G.marked[ds] = 1;
    } else {
      G.marked[ss] = 1;
      G.marked[ds] = 1;
    }
  }
}

void sort_edges_by_dest(Graph& G) {
  for (auto& lst : G.adj) {
    if (lst.size() > 1) {
      std::sort(lst.begin(), lst.end(), [](const PEdge* a, const PEdge* b) {
        const uint64_t ka = (a->dst << 32) |
                            static_cast<uint64_t>(a->edge_length());
        const uint64_t kb = (b->dst << 32) |
                            static_cast<uint64_t>(b->edge_length());
        return ka < kb;
      });
    }
  }
}

int64_t contract_composite_par(Graph& G, bool check_marked) {
  const int64_t n = static_cast<int64_t>(G.keys.size());
  std::vector<PEdge*> add_list;
  std::vector<uint8_t> consumed(n, 0);
  std::vector<int32_t> visit_stamp(n, -1);
  auto node_ok = [&](int32_t slot) {
    return !check_marked || G.marked[slot] != 0;
  };

  int32_t chain = -1;
  for (int64_t start = 0; start < n; ++start) {
    if (consumed[start]) continue;
    consumed[start] = 1;
    auto& lst = G.adj[start];
    if (lst.size() != 2 || !node_ok(static_cast<int32_t>(start))) continue;
    PEdge* edge1 = lst[0]->twin;
    PEdge* edge2 = lst[1];
    if (!(is_mergeable_o(edge1->orient, edge2->orient) && !edge1->is_loop() &&
          !edge2->is_loop() && node_ok(edge1->src_slot) &&
          node_ok(edge2->dst_slot)))
      continue;
    edge1->invalid = edge1->twin->invalid = true;
    edge2->invalid = edge2->twin->invalid = true;

    ++chain;
    visit_stamp[start] = chain;  // visited = {edge2.src == start}
    ChainTemp cur_fwd;
    cur_fwd.init_from(G, edge2);
    for (;;) {
      const int32_t nxt = cur_fwd.dst_slot;
      auto& elist = G.adj[nxt];
      if (elist.size() != 2) break;
      PEdge* nfe = elist[1];
      if (visit_stamp[nfe->dst_slot] == chain) nfe = elist[0];
      if (visit_stamp[nfe->dst_slot] == chain) break;
      if (is_mergeable_o(cur_fwd.orient, nfe->orient) && !nfe->is_loop() &&
          !cur_fwd.loop && node_ok(nfe->dst_slot)) {
        consumed[nxt] = 1;
        visit_stamp[nxt] = chain;
        nfe->invalid = nfe->twin->invalid = true;
        cur_fwd.extend_forward(G, nfe);
      } else {
        break;
      }
    }

    ChainTemp cur_rev;
    cur_rev.init_from(G, edge1);
    for (;;) {
      const int32_t nxt = cur_rev.src_slot;
      auto& elist = G.adj[nxt];
      if (elist.size() != 2) break;
      PEdge* nre = elist[0]->twin;
      if (visit_stamp[nre->src_slot] == chain) nre = elist[1]->twin;
      if (visit_stamp[nre->src_slot] == chain) break;
      if (is_mergeable_o(nre->orient, cur_rev.orient) && !nre->is_loop() &&
          !cur_rev.loop && node_ok(nre->src_slot)) {
        consumed[nxt] = 1;
        visit_stamp[nxt] = chain;
        nre->invalid = nre->twin->invalid = true;
        cur_rev.extend_backward(G, nre);
      } else {
        break;
      }
    }

    add_list.push_back(finish_chain(G, cur_rev, cur_fwd));
  }

  // delete invalidated edges (order-preserving compaction per list)
  for (int64_t k = 0; k < n; ++k) {
    auto& lst = G.adj[k];
    size_t j = 0;
    while (j < lst.size()) {
      if (lst[j]->invalid) {
        G.remove_edge(lst[j]);
      } else {
        ++j;
      }
    }
  }

  int64_t counter = 0;
  for (PEdge* e : add_list) {
    if (!G.exists_edge(e)) {
      G.insert_edge(e);
      ++counter;
    } else {
      G.free_pair(e);
    }
  }
  return counter;
}

int64_t contract_composite_serial(Graph& G) {
  int64_t counter = 0;
  const int64_t n = static_cast<int64_t>(G.keys.size());
  for (int64_t rid = 0; rid < n; ++rid) {  // slot order == sorted(marked)
    if (!G.marked[rid]) continue;
    auto& lst = G.adj[rid];
    if (lst.size() != 2) continue;
    PEdge* edge1 = lst[0]->twin;
    PEdge* edge2 = lst[1];
    if (!G.marked[edge1->src_slot] || !G.marked[edge2->dst_slot]) continue;
    if (is_mergeable_o(edge1->orient, edge2->orient) && !edge1->is_loop() &&
        !edge2->is_loop()) {
      PEdge* new_edge = add_edges(G, edge1, edge2);
      G.insert_edge(new_edge);
      if (edge2 != edge1->twin) G.remove_edge(edge2);
      G.remove_edge(edge1);
      ++counter;
    }
  }
  return counter;
}

int64_t remove_par_dead_ends(Graph& G) {
  const int64_t n = static_cast<int64_t>(G.keys.size());
  std::vector<int64_t> to_remove;
  for (int64_t nid = 0; nid < n; ++nid) {  // node_list == sorted(marked)
    if (!G.marked[nid]) continue;
    auto& lst = G.adj[nid];
    if (lst.empty()) continue;
    bool is_dead_end = true;
    int64_t in_e = 0, out_e = 0;
    for (PEdge* e : lst) {
      if (!G.marked[e->dst_slot]) {
        is_dead_end = false;
        break;
      }
      if (e->is_not_dead_end()) {
        is_dead_end = false;
        break;
      }
      if (static_cast<int64_t>(e->inner.size()) >= MIN_READS_NOT_DEAD_END) {
        e->mark_not_dead_end();
        is_dead_end = false;
        break;
      }
      if (e->edge_length() >= MIN_LEN_NOT_DEAD_END) {
        e->mark_not_dead_end();
        is_dead_end = false;
        break;
      }
      if (e->is_loop()) {
        e->mark_not_dead_end();
        is_dead_end = false;
        break;
      }
      if ((e->orient >> 1) & 1) {
        ++out_e;
      } else {
        ++in_e;
      }
    }
    if (is_dead_end && in_e * out_e == 0 && in_e + out_e > 0)
      to_remove.push_back(nid);
  }
  int64_t deleted = 0;
  for (int64_t nid : to_remove) {
    auto& lst = G.adj[nid];
    while (!lst.empty()) {
      G.remove_edge(lst[0]);
      ++deleted;
    }
  }
  return deleted;
}

void print_par_edges(const Graph& G, std::string& out) {
  char buf[128];
  for (const auto& lst : G.adj) {
    for (const PEdge* e : lst) {
      if (!e->is_smaller()) continue;
      int len = std::snprintf(buf, sizeof buf,
                              "%llu\t%llu\t%d,%lld,%lld,0,0\t",
                              (unsigned long long)e->src,
                              (unsigned long long)e->dst, e->orient,
                              (long long)e->offset,
                              (long long)e->edge_length());
      out.append(buf, len);
      for (const Inner& in : e->inner) {
        len = std::snprintf(buf, sizeof buf, "(%llu,%d,%lld)",
                            (unsigned long long)in.rid, (int)in.ori,
                            (long long)in.off);
        out.append(buf, len);
      }
      out.push_back('\n');
    }
  }
}

}  // namespace

extern "C" {

// Runs the full parsimplify phase: edge_file -> out_file.  Returns 0 on
// success, -1 on I/O error.
int64_t parsimplify_run(const char* edge_file, const char* out_file,
                        int64_t min_ovl) {
  Graph G;
  std::vector<RawEdge> raw;
  if (!parse_edges(edge_file, min_ovl, raw)) return -1;
  build_graph(G, raw);
  raw.clear();
  raw.shrink_to_fit();
  sort_edges_by_dest(G);
  contract_composite_par(G, /*check_marked=*/true);
  for (;;) {
    int64_t c = contract_composite_serial(G);
    c += remove_par_dead_ends(G);
    if (c == 0) break;
  }
  std::string out;
  print_par_edges(G, out);
  FILE* f = std::fopen(out_file, "wb");
  if (!f) return -1;
  if (!out.empty() && std::fwrite(out.data(), 1, out.size(), f) !=
                          out.size()) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
