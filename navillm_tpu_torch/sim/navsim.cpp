// navsim: native nav-graph engine for NaviLLM-TPU.
//
// The port's copy of navillm_tpu/sim/navsim.cpp, built by
// navillm_tpu_torch/sim/native.py into build/navillm_tpu_torch/.
//
// Replaces three host-side hot spots of the reference implementation:
//   1. per-scan all-pairs shortest paths (reference: networkx Dijkstra,
//      tasks/datasets/mp3d_dataset.py:122-138) -> C++ Dijkstra at graph load;
//   2. the per-episode incremental Floyd shortest-path memory (reference:
//      models/graph_utils.py:47-96, O(V^2) Python per visited node);
//   3. batched distance/path queries during rollouts and metric evaluation.
//
// Plain C ABI (used via ctypes). Node ids are dense ints; the Python layer
// owns the viewpoint-string <-> index mapping.

#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr double INF = std::numeric_limits<double>::infinity();

struct ScanGraph {
  int n = 0;
  std::vector<double> dist;      // n*n all-pairs distances
  std::vector<int32_t> next;     // n*n next-hop on shortest path, -1 if none
  std::vector<std::vector<std::pair<int, double>>> adj;
};

struct EpisodeGraph {
  // Incremental all-pairs over the *discovered* subgraph, exactly matching
  // the reference FloydGraph semantics: distances only improve when a node
  // is visited (update(k) relaxes every pair through k).
  int cap = 0;
  int n = 0;  // nodes added so far
  std::vector<double> dist;      // cap*cap
  std::vector<int32_t> mid;      // cap*cap via-node (-1: direct edge)
  std::vector<uint8_t> visited;  // cap
};

std::vector<ScanGraph*> g_scans;
std::vector<EpisodeGraph*> g_eps;
std::vector<int64_t> g_ep_free;   // recycled EpisodeGraph handles

void dijkstra(const ScanGraph& g, int src, double* dist, int32_t* parent) {
  std::vector<uint8_t> done(g.n, 0);
  for (int i = 0; i < g.n; i++) { dist[i] = INF; parent[i] = -1; }
  dist[src] = 0.0;
  using QE = std::pair<double, int>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
  pq.push({0.0, src});
  while (!pq.empty()) {
    auto [d, u] = pq.top(); pq.pop();
    if (done[u]) continue;
    done[u] = 1;
    for (auto [v, w] : g.adj[u]) {
      if (d + w < dist[v]) {
        dist[v] = d + w;
        parent[v] = u;
        pq.push({dist[v], v});
      }
    }
  }
}

}  // namespace

extern "C" {

void ep_reset(int64_t h);   // fwd decl (used by ep_create's recycling)

// ---------------------------------------------------------------- ScanGraph

// Create a scan graph from an undirected edge list and run all-pairs
// Dijkstra. Returns a handle (>= 0).
int64_t ns_scan_create(int32_t n, int32_t m, const int32_t* edges,
                       const double* weights) {
  auto* g = new ScanGraph();
  g->n = n;
  g->adj.assign(n, {});
  for (int e = 0; e < m; e++) {
    int a = edges[2 * e], b = edges[2 * e + 1];
    g->adj[a].push_back({b, weights[e]});
    g->adj[b].push_back({a, weights[e]});
  }
  g->dist.assign((size_t)n * n, INF);
  g->next.assign((size_t)n * n, -1);
  std::vector<double> d(n);
  std::vector<int32_t> par(n);
  for (int s = 0; s < n; s++) {
    dijkstra(*g, s, d.data(), par.data());
    for (int t = 0; t < n; t++) {
      g->dist[(size_t)s * n + t] = d[t];
      if (t == s || par[t] < 0) continue;
      // next hop from s toward t: walk parents back from t
      int cur = t;
      while (par[cur] != s) cur = par[cur];
      g->next[(size_t)s * n + t] = cur;
    }
  }
  g_scans.push_back(g);
  return (int64_t)g_scans.size() - 1;
}

double ns_scan_distance(int64_t h, int32_t a, int32_t b) {
  const auto& g = *g_scans[h];
  return g.dist[(size_t)a * g.n + b];
}

// Copy the full distance matrix (n*n doubles) to out.
void ns_scan_dist_matrix(int64_t h, double* out) {
  const auto& g = *g_scans[h];
  std::memcpy(out, g.dist.data(), sizeof(double) * g.n * g.n);
}

// Shortest path a..b inclusive; returns length (#nodes) or 0 if unreachable.
int32_t ns_scan_path(int64_t h, int32_t a, int32_t b, int32_t* out,
                     int32_t cap) {
  const auto& g = *g_scans[h];
  if (a == b) { if (cap > 0) out[0] = a; return 1; }
  if (g.dist[(size_t)a * g.n + b] == INF) return 0;
  int len = 0, cur = a;
  while (cur != b) {
    if (len < cap) out[len] = cur;
    len++;
    cur = g.next[(size_t)cur * g.n + b];
    if (cur < 0) return 0;
  }
  if (len < cap) out[len] = b;
  return len + 1;
}

// Batched queries used by metrics: distances for (k) pairs.
void ns_scan_distances(int64_t h, int32_t k, const int32_t* a,
                       const int32_t* b, double* out) {
  const auto& g = *g_scans[h];
  for (int i = 0; i < k; i++) out[i] = g.dist[(size_t)a[i] * g.n + b[i]];
}

// ------------------------------------------------------------- EpisodeGraph

int64_t ep_create(int32_t cap) {
  // recycle a freed slot with matching capacity when available: episode
  // graphs are created per rollout episode, so without reuse a long
  // training run leaks cap^2 * 12 bytes per episode
  if (!g_ep_free.empty()) {
    int64_t h = g_ep_free.back();
    if (g_eps[h]->cap == cap) {
      g_ep_free.pop_back();
      ep_reset(h);
      return h;
    }
  }
  auto* e = new EpisodeGraph();
  e->cap = cap;
  e->dist.assign((size_t)cap * cap, INF);
  e->mid.assign((size_t)cap * cap, -1);
  e->visited.assign(cap, 0);
  for (int i = 0; i < cap; i++) e->dist[(size_t)i * cap + i] = 0.0;
  g_eps.push_back(e);
  return (int64_t)g_eps.size() - 1;
}

void ep_free(int64_t h) { g_ep_free.push_back(h); }

void ep_reset(int64_t h) {
  auto& e = *g_eps[h];
  std::fill(e.dist.begin(), e.dist.end(), INF);
  std::fill(e.mid.begin(), e.mid.end(), -1);
  std::fill(e.visited.begin(), e.visited.end(), 0);
  for (int i = 0; i < e.cap; i++) e.dist[(size_t)i * e.cap + i] = 0.0;
  e.n = 0;
}

void ep_ensure(int64_t h, int32_t node) {
  auto& e = *g_eps[h];
  if (node + 1 > e.n) e.n = node + 1;
}

void ep_add_edge(int64_t h, int32_t a, int32_t b, double w) {
  auto& e = *g_eps[h];
  ep_ensure(h, a >= b ? a : b);
  size_t ab = (size_t)a * e.cap + b, ba = (size_t)b * e.cap + a;
  if (w < e.dist[ab]) {
    e.dist[ab] = e.dist[ba] = w;
    e.mid[ab] = e.mid[ba] = -1;
  }
}

// Mark k visited and relax all pairs through it (reference
// graph_utils.py:66-75 semantics, including recording the via node).
void ep_update(int64_t h, int32_t k) {
  auto& e = *g_eps[h];
  const int n = e.n, cap = e.cap;
  const double* dk = &e.dist[(size_t)k * cap];
  for (int x = 0; x < n; x++) {
    if (x == k) continue;
    const double dxk = e.dist[(size_t)x * cap + k];
    if (dxk == INF) continue;
    double* dx = &e.dist[(size_t)x * cap];
    int32_t* mx = &e.mid[(size_t)x * cap];
    for (int y = 0; y < n; y++) {
      if (y == x) continue;
      const double cand = dxk + dk[y];
      if (cand < dx[y]) {
        dx[y] = cand;
        mx[y] = k;
        e.dist[(size_t)y * cap + x] = cand;
        e.mid[(size_t)y * cap + x] = k;
      }
    }
  }
  e.visited[k] = 1;
}

int32_t ep_visited(int64_t h, int32_t k) { return g_eps[h]->visited[k]; }

double ep_distance(int64_t h, int32_t a, int32_t b) {
  const auto& e = *g_eps[h];
  if (a == b) return 0.0;
  return e.dist[(size_t)a * e.cap + b];
}

// All distances from a to nodes [0, n): used to build the gmap pairwise
// distance matrix in one call instead of O(N^2) Python.
void ep_distances_from(int64_t h, int32_t a, double* out) {
  const auto& e = *g_eps[h];
  std::memcpy(out, &e.dist[(size_t)a * e.cap], sizeof(double) * e.n);
  out[a] = 0.0;
}

int32_t ep_num_nodes(int64_t h) { return g_eps[h]->n; }

static int ep_path_rec(const EpisodeGraph& e, int x, int y, int32_t* out,
                       int cap, int pos) {
  // Path excluding x, including y (reference FloydGraph.path semantics).
  if (x == y) return pos;
  int32_t k = e.mid[(size_t)x * e.cap + y];
  if (k < 0) {
    if (pos < cap) out[pos] = y;
    return pos + 1;
  }
  pos = ep_path_rec(e, x, k, out, cap, pos);
  return ep_path_rec(e, k, y, out, cap, pos);
}

int32_t ep_path(int64_t h, int32_t a, int32_t b, int32_t* out, int32_t cap) {
  return ep_path_rec(*g_eps[h], a, b, out, cap, 0);
}

static int ep_path_len_rec(const EpisodeGraph& e, int x, int y) {
  if (x == y) return 0;
  int32_t k = e.mid[(size_t)x * e.cap + y];
  if (k < 0) return 1;
  return ep_path_len_rec(e, x, k) + ep_path_len_rec(e, k, y);
}

// Batched (distance, path-step-count) from src to k nodes — one ctypes
// call per rollout step feeds GraphMap.get_pos_fts (the reference calls
// graph.distance + len(graph.path) per node, graph_utils.py:158-161).
void ep_dist_steps(int64_t h, int32_t src, int32_t k, const int32_t* ids,
                   double* out_dist, int32_t* out_steps) {
  const auto& e = *g_eps[h];
  for (int i = 0; i < k; i++) {
    if (ids[i] == src) {
      out_dist[i] = 0.0;
      out_steps[i] = 0;
    } else {
      out_dist[i] = e.dist[(size_t)src * e.cap + ids[i]];
      out_steps[i] = ep_path_len_rec(e, src, ids[i]);
    }
  }
}

// Pairwise distance matrix over an ordered node subset (k ids) — one call
// per rollout step replaces the reference's Python double loop
// (tasks/agents/mp3d_agent.py:337-341).
void ep_pair_dists(int64_t h, int32_t k, const int32_t* ids, double* out) {
  const auto& e = *g_eps[h];
  for (int i = 0; i < k; i++) {
    const double* di = &e.dist[(size_t)ids[i] * e.cap];
    for (int j = 0; j < k; j++) {
      out[(size_t)i * k + j] = (ids[i] == ids[j]) ? 0.0 : di[ids[j]];
    }
  }
}

void ns_free_all() {
  for (auto* g : g_scans) delete g;
  for (auto* e : g_eps) delete e;
  g_scans.clear();
  g_eps.clear();
}

}  // extern "C"
