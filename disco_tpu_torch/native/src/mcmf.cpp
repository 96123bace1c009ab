// Min-cost max-flow: successive shortest paths with Johnson potentials,
// lower bounds via the excess transformation.  Clean-room replacement for
// the license-encumbered CS2 solver the reference uses
// (reference: src/SimplifyGraph/src/CS2_stream/cs2.h:1-4; driven from
// OverlapGraph::calculateFlowStream, OverlapGraph.cpp:1497-1498).
//
// This is an exact operation-order port of disco_tpu/simplify/flow.py's
// solve_flow (arc insertion order, Bellman-Ford sweep order, Dijkstra with
// (dist, node) heap ordering) so both produce the SAME per-arc flow vector
// — min-cost optima are not unique, and downstream graph pruning consumes
// the arc flows, so solver interchangeability requires vector equality,
// not just cost equality.
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

namespace {

constexpr int64_t INF = int64_t(1) << 60;
constexpr int64_t BIG_CAP = int64_t(1) << 40;

struct Net {
  int64_t n;
  std::vector<int64_t> to, cap, cost, first, nxt;
  explicit Net(int64_t n_) : n(n_), first(n_, -1) {}
  int64_t add(int64_t u, int64_t v, int64_t c, int64_t w) {
    int64_t i = static_cast<int64_t>(to.size());
    to.push_back(v); cap.push_back(c); cost.push_back(w);
    nxt.push_back(first[u]); first[u] = i;
    to.push_back(u); cap.push_back(0); cost.push_back(-w);
    nxt.push_back(first[v]); first[v] = i + 1;
    return i;
  }
};

}  // namespace

extern "C" int64_t mcmf_solve(int64_t v_nodes, int64_t n_arcs,
                              const int64_t* tail, const int64_t* head,
                              const int64_t* lb, const int64_t* ub,
                              const int64_t* cost, int64_t* flow_out) {
  // nodes 1..v_nodes, plus S=0 and T=v_nodes+1 for the lower-bound excess
  const int64_t S = 0, T = v_nodes + 1;
  Net net(v_nodes + 2);
  std::vector<int64_t> excess(v_nodes + 2, 0);
  std::vector<int64_t> arc_ids(n_arcs);
  for (int64_t a = 0; a < n_arcs; ++a) {
    int64_t capac = ub[a] < 0 ? BIG_CAP : ub[a];
    arc_ids[a] = net.add(tail[a], head[a], capac - lb[a], cost[a]);
    excess[tail[a]] -= lb[a];
    excess[head[a]] += lb[a];
  }
  int64_t total = 0;
  for (int64_t v = 1; v <= v_nodes; ++v) {
    if (excess[v] > 0) { net.add(S, v, excess[v], 0); total += excess[v]; }
    else if (excess[v] < 0) { net.add(v, T, -excess[v], 0); }
  }

  const int64_t n = net.n;
  std::vector<int64_t> pot(n, 0);
  for (int64_t round = 0; round < n; ++round) {
    bool changed = false;
    for (int64_t u = 0; u < n; ++u) {
      int64_t pu = pot[u];
      for (int64_t i = net.first[u]; i != -1; i = net.nxt[i]) {
        if (net.cap[i] > 0 && pu + net.cost[i] < pot[net.to[i]]) {
          pot[net.to[i]] = pu + net.cost[i];
          changed = true;
        }
      }
    }
    if (!changed) break;
  }

  std::vector<int64_t> dist(n), par(n);
  using QE = std::pair<int64_t, int64_t>;  // (dist, node): heapq tie order
  int64_t sent = 0;
  while (sent < total) {
    std::fill(dist.begin(), dist.end(), INF);
    std::fill(par.begin(), par.end(), -1);
    dist[S] = 0;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    pq.push({0, S});
    while (!pq.empty()) {
      auto [d, u] = pq.top();
      pq.pop();
      if (d > dist[u]) continue;
      for (int64_t i = net.first[u]; i != -1; i = net.nxt[i]) {
        if (net.cap[i] > 0) {
          int64_t v = net.to[i];
          int64_t nd = d + net.cost[i] + pot[u] - pot[v];
          if (nd < dist[v]) {
            dist[v] = nd;
            par[v] = i;
            pq.push({nd, v});
          }
        }
      }
    }
    if (dist[T] >= INF) return -1;  // infeasible
    for (int64_t v = 0; v < n; ++v)
      if (dist[v] < INF) pot[v] += dist[v];
    int64_t push = INF;
    for (int64_t v = T; v != S; v = net.to[par[v] ^ 1])
      push = std::min(push, net.cap[par[v]]);
    for (int64_t v = T; v != S; v = net.to[par[v] ^ 1]) {
      net.cap[par[v]] -= push;
      net.cap[par[v] ^ 1] += push;
    }
    sent += push;
  }

  for (int64_t a = 0; a < n_arcs; ++a) {
    int64_t capac = ub[a] < 0 ? BIG_CAP : ub[a];
    flow_out[a] = lb[a] + (capac - lb[a] - net.cap[arc_ids[a]]);
  }
  return 0;
}
