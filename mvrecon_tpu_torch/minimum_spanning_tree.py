"""Minimum spanning tree (Kruskal) over a weighted view graph.

Counterpart of ``mvrecon_tpu/minimum_spanning_tree.py`` (the reference's
``UnionFind`` and ``MinimumSpanningTree.solve/to_adjacency_matrix``).
Kruskal's union-find walk is sequential and data-dependent, so it runs on
the host: in C++ (``runtime/native/mst.cpp``, built at first use) or, when
that library cannot be built, in NumPy; ``runtime.native.mst_native.
available()`` says which. Edges are sorted stably by weight, so ties
resolve in input order on either route, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .runtime.native import mst_native


class UnionFind:
    """Disjoint sets with path halving and union by rank."""

    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.rank = np.zeros(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, x: int, y: int) -> bool:
        px, py = self.find(x), self.find(y)
        if px == py:
            return False
        if self.rank[px] > self.rank[py]:
            self.parent[py] = px
        else:
            self.parent[px] = py
            if self.rank[px] == self.rank[py]:
                self.rank[py] += 1
        return True


class MinimumSpanningTree:
    """Kruskal MST over ``edges`` (N, 2) with ``weights`` (N,)."""

    def __init__(self, edges, weights):
        edges = np.asarray(edges)
        weights = np.asarray(weights)
        if len(edges) != len(weights):
            raise ValueError("edges and weights must have equal length")
        order = np.argsort(weights, kind="stable")
        self._sorted_edges = np.hstack((edges, weights[:, None]))[order]
        self._n_nodes = int(np.max(edges)) + 1

    def solve(self):
        """The accepted edges as rows (i, j, w), in weight order."""
        e = self._sorted_edges
        if mst_native.available():
            keep = mst_native.kruskal(e[:, 0].astype(np.int64), e[:, 1].astype(np.int64),
                                      self._n_nodes)
            return e[keep.astype(bool)]
        uf = UnionFind(self._n_nodes)
        rows = [row for row in e if uf.union(int(row[0]), int(row[1]))]
        return np.vstack(rows)

    def to_adjacency_matrix(self, result):
        """(adjacency (n, n) uint8, distance (n, n) with NaN off the tree)."""
        i_arr = result[:, 0].astype(np.int64)
        j_arr = result[:, 1].astype(np.int64)
        adjacency = np.zeros((self._n_nodes, self._n_nodes), dtype=np.uint8)
        adjacency[i_arr, j_arr] = 1
        adjacency[j_arr, i_arr] = 1
        distance = np.full(adjacency.shape, np.nan)
        distance[i_arr, j_arr] = result[:, 2]
        distance[j_arr, i_arr] = result[:, 2]
        return adjacency, distance
