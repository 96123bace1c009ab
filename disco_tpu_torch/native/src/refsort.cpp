// Native helpers for parity-exact replay of the reference assembler.
//
// The reference sorts edge vectors with std::sort and a comparator on a
// single key (e.g. overlap offset, reference:
// src/BuildGraph/src/OverlapGraph.cpp:39-42,676). libstdc++'s std::sort is an
// introsort that is NOT stable for ranges longer than 16 elements, so the
// ordering of equal keys is algorithm-defined. Rather than re-implementing
// introsort in Python, we call the real std::sort on (key, index) pairs with
// a key-only comparator: the comparator decisions — and therefore the final
// permutation of tied elements — are identical to sorting the reference's
// pointer vectors.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {
struct KV {
    uint64_t k;
    int64_t v;
};
struct KVI {
    int64_t k;
    int64_t v;
};
}  // namespace

extern "C" {

// out_perm[i] = original index of the element at sorted position i.
void stdsort_by_key_u64(const uint64_t* keys, int64_t* out_perm, int64_t n) {
    std::vector<KV> a(n);
    for (int64_t i = 0; i < n; i++) a[i] = {keys[i], i};
    std::sort(a.begin(), a.end(),
              [](const KV& x, const KV& y) { return x.k < y.k; });
    for (int64_t i = 0; i < n; i++) out_perm[i] = a[i].v;
}

void stdsort_by_key_i64(const int64_t* keys, int64_t* out_perm, int64_t n) {
    std::vector<KVI> a(n);
    for (int64_t i = 0; i < n; i++) a[i] = {keys[i], i};
    std::sort(a.begin(), a.end(),
              [](const KVI& x, const KVI& y) { return x.k < y.k; });
    for (int64_t i = 0; i < n; i++) out_perm[i] = a[i].v;
}

// Descending by key (used by simplification operators that sort greatest
// first, e.g. reference: src/SimplifyGraph/src/OverlapGraph.cpp support sort).
void stdsort_by_key_i64_desc(const int64_t* keys, int64_t* out_perm, int64_t n) {
    std::vector<KVI> a(n);
    for (int64_t i = 0; i < n; i++) a[i] = {keys[i], i};
    std::sort(a.begin(), a.end(),
              [](const KVI& x, const KVI& y) { return x.k > y.k; });
    for (int64_t i = 0; i < n; i++) out_perm[i] = a[i].v;
}
}
