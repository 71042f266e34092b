// Kruskal minimum spanning tree over weight-sorted edges (host side).
//
// Union-find with path halving and union by rank. The view-graph MST is a
// sequential, data-dependent walk over the edges, so it runs on the host
// in C++, loaded by ctypes from mst_native.py.
//
// Input edges must already be sorted by weight. Writes 1 into keep[k] for
// every edge accepted into the tree.

#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int64_t> rank;

  explicit UnionFind(int64_t n) : parent(n), rank(n, 0) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }

  int64_t find(int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }

  bool unite(int64_t x, int64_t y) {
    int64_t px = find(x), py = find(y);
    if (px == py) return false;
    if (rank[px] > rank[py]) {
      parent[py] = px;
    } else {
      parent[px] = py;
      if (rank[px] == rank[py]) ++rank[py];
    }
    return true;
  }
};

}  // namespace

extern "C" {

// edges_i/edges_j: endpoints of n_edges weight-sorted edges over n_nodes
// nodes; keep: out buffer of n_edges bytes (1 = edge in the tree).
// Returns the number of accepted edges.
int64_t mvrecon_kruskal(const int64_t* edges_i, const int64_t* edges_j,
                        int64_t n_edges, int64_t n_nodes, uint8_t* keep) {
  UnionFind uf(n_nodes);
  int64_t accepted = 0;
  for (int64_t k = 0; k < n_edges; ++k) {
    if (uf.unite(edges_i[k], edges_j[k])) {
      keep[k] = 1;
      ++accepted;
    } else {
      keep[k] = 0;
    }
  }
  return accepted;
}

}  // extern "C"
