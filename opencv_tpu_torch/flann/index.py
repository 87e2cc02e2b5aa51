"""FLANN-compatible ANN indexes: randomized kd-trees, hierarchical
k-means, multi-table LSH, linear — plus the `cv::flann::Index` wrapper
with save/load persistence.  A copy of ``opencv_tpu/flann/index.py``.

Reference: `modules/flann/include/opencv2/flann/kdtree_index.h` (build
:~120, searchLevel backtracking), `kmeans_index.h` (hierarchical
clustering + priority domain traversal), `lsh_index.h`/`lsh_table.h`
(bit-subset keys, multi-probe), `src/miniflann.cpp` (the cv wrapper).

Index construction and tree traversal are irregular pointer-chasing, a
host tail in numpy as in the JAX package; a tensor argument is read back to
the host once.  An index that the JAX package saved (`Index.save`, one
``.npz``) loads here and searches to the same answers.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

FLANN_INDEX_LINEAR = 0
FLANN_INDEX_KDTREE = 1
FLANN_INDEX_KMEANS = 2
FLANN_INDEX_COMPOSITE = 3
FLANN_INDEX_KDTREE_SINGLE = 4
FLANN_INDEX_HIERARCHICAL = 5
FLANN_INDEX_LSH = 6
FLANN_INDEX_SAVED = 254
FLANN_INDEX_AUTOTUNED = 255

__all__ = [
    "Index", "LinearIndex", "KDTreeIndex", "KMeansIndex", "LshIndex",
    "FLANN_INDEX_LINEAR", "FLANN_INDEX_KDTREE", "FLANN_INDEX_KMEANS",
    "FLANN_INDEX_COMPOSITE", "FLANN_INDEX_KDTREE_SINGLE",
    "FLANN_INDEX_HIERARCHICAL", "FLANN_INDEX_LSH", "FLANN_INDEX_SAVED",
    "FLANN_INDEX_AUTOTUNED",
]


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _l2sq(q, pts):
    """Squared L2 rows(q) × rows(pts) — FLANN reports L2 as SQUARED."""
    return ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)


def _hamming(q, pts):
    return np.unpackbits(q[:, None, :] ^ pts[None, :, :], axis=2).sum(2)


# --------------------------------------------------------------------------
# Linear (brute force)
# --------------------------------------------------------------------------

class LinearIndex:
    algorithm = FLANN_INDEX_LINEAR

    def __init__(self, data, **params):
        self.data = np.ascontiguousarray(data)
        self.binary = self.data.dtype == np.uint8

    def knn_search(self, queries, knn, checks=32):
        d = (_hamming if self.binary else _l2sq)(
            np.asarray(queries, self.data.dtype), self.data)
        k = min(knn, self.data.shape[0])
        idx = np.argpartition(d, k - 1, axis=1)[:, :k]
        row = np.arange(d.shape[0])[:, None]
        order = np.argsort(d[row, idx], axis=1, kind="stable")
        idx = idx[row, order]
        return idx.astype(np.int32), d[row, idx].astype(np.float32)

    def state(self):
        return {}

    @classmethod
    def from_state(cls, data, st, params):
        return cls(data)


# --------------------------------------------------------------------------
# Randomized kd-tree forest (kdtree_index.h)
# --------------------------------------------------------------------------

class KDTreeIndex:
    """Forest of `trees` randomized kd-trees with best-bin-first search.

    Each tree: split dimension drawn from the top-5 highest-variance dims
    of a node sample, split value = mean (kdtree_index.h divideTree).
    Search descends every tree, then backtracks through a shared priority
    queue until `checks` points have been examined.
    """

    algorithm = FLANN_INDEX_KDTREE
    RAND_DIM = 5
    SAMPLE_MEAN = 100

    def __init__(self, data, trees=4, random_seed=0, _build=True, **params):
        self.data = np.ascontiguousarray(data, np.float32)
        self.trees = int(trees)
        self.seed = int(random_seed)
        if _build:
            self._build()

    def _build(self):
        rng = np.random.default_rng(self.seed)
        n, dim = self.data.shape
        # array-layout trees: node i has children 2i+1 / 2i+2 conceptually;
        # stored as flat lists since subtrees are unbalanced
        self.split_dim = []   # int32 per node (-1 = leaf)
        self.split_val = []   # f32 per node
        self.left = []        # int32 child node ids
        self.right = []
        self.leaf_pts = []    # point id for leaf nodes (single point)
        self.roots = []

        def build_node(ids):
            node = len(self.split_dim)
            self.split_dim.append(-1)
            self.split_val.append(0.0)
            self.left.append(-1)
            self.right.append(-1)
            self.leaf_pts.append(-1)
            if len(ids) == 1:
                self.leaf_pts[node] = ids[0]
                return node
            sample = ids if len(ids) <= self.SAMPLE_MEAN else \
                rng.choice(ids, self.SAMPLE_MEAN, replace=False)
            pts = self.data[sample]
            var = pts.var(axis=0)
            top = np.argsort(var)[::-1][:self.RAND_DIM]
            d = int(top[rng.integers(0, min(self.RAND_DIM, len(top)))])
            v = float(pts[:, d].mean())
            mask = self.data[ids, d] < v
            li, ri = ids[mask], ids[~mask]
            if len(li) == 0 or len(ri) == 0:
                half = len(ids) // 2
                order = np.argsort(self.data[ids, d], kind="stable")
                li, ri = ids[order[:half]], ids[order[half:]]
                v = float(self.data[ids[order[half]], d])
            self.split_dim[node] = d
            self.split_val[node] = v
            self.left[node] = build_node(li)
            self.right[node] = build_node(ri)
            return node

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            for _ in range(self.trees):
                self.roots.append(build_node(np.arange(n)))
        finally:
            sys.setrecursionlimit(old)
        self.split_dim = np.asarray(self.split_dim, np.int32)
        self.split_val = np.asarray(self.split_val, np.float32)
        self.left = np.asarray(self.left, np.int32)
        self.right = np.asarray(self.right, np.int32)
        self.leaf_pts = np.asarray(self.leaf_pts, np.int32)

    def _search_one(self, q, knn, checks):
        heap = []  # (mindist, node)
        best = []  # (-dist, pt)
        visited = 0
        checked = set()  # kdtree_index.h checkID bitset: dedup across trees

        def descend(node, mindist):
            nonlocal visited
            while self.split_dim[node] >= 0:
                d = self.split_dim[node]
                diff = q[d] - self.split_val[node]
                if diff < 0:
                    other = self.right[node]
                    node = self.left[node]
                else:
                    other = self.left[node]
                    node = self.right[node]
                heapq.heappush(heap, (mindist + diff * diff, other))
            pt = int(self.leaf_pts[node])
            if pt in checked:
                return
            checked.add(pt)
            dist = float(((q - self.data[pt]) ** 2).sum())
            visited += 1
            if len(best) < knn:
                heapq.heappush(best, (-dist, pt))
            elif dist < -best[0][0]:
                heapq.heapreplace(best, (-dist, pt))

        for r in self.roots:
            descend(r, 0.0)
        while heap and visited < checks:
            mind, node = heapq.heappop(heap)
            if len(best) == knn and mind > -best[0][0]:
                continue
            descend(node, mind)
        out = sorted(((-d, p) for d, p in best))
        idx = np.full(knn, -1, np.int32)
        dst = np.full(knn, np.float32(np.inf), np.float32)
        for i, (d, p) in enumerate(out):
            idx[i] = p
            dst[i] = d
        return idx, dst

    def knn_search(self, queries, knn, checks=32):
        q = np.asarray(queries, np.float32)
        idx = np.empty((len(q), knn), np.int32)
        dst = np.empty((len(q), knn), np.float32)
        for i in range(len(q)):
            idx[i], dst[i] = self._search_one(q[i], knn, checks)
        return idx, dst

    def state(self):
        return {"split_dim": self.split_dim, "split_val": self.split_val,
                "left": self.left, "right": self.right,
                "leaf_pts": self.leaf_pts,
                "roots": np.asarray(self.roots, np.int32),
                "trees": np.asarray([self.trees])}

    @classmethod
    def from_state(cls, data, st, params):
        params = {k: v for k, v in params.items() if k != "trees"}
        obj = cls(data, trees=int(st["trees"][0]), _build=False, **params)
        obj.split_dim = st["split_dim"]
        obj.split_val = st["split_val"]
        obj.left = st["left"]
        obj.right = st["right"]
        obj.leaf_pts = st["leaf_pts"]
        obj.roots = [int(r) for r in st["roots"]]
        return obj


# --------------------------------------------------------------------------
# Hierarchical k-means tree (kmeans_index.h)
# --------------------------------------------------------------------------

class KMeansIndex:
    """Hierarchical k-means tree with priority domain traversal.

    Build: recursive k-means with `branching` clusters per node,
    `iterations` Lloyd steps (kmeans_index.h computeClustering).  Search:
    descend to the closest domain, keep the others in a priority queue
    keyed by distance-to-center, pop domains until `checks` points seen.
    Distance evaluations are dense matrix ops (MXU-shaped).
    """

    algorithm = FLANN_INDEX_KMEANS

    def __init__(self, data, branching=32, iterations=11, leaf_size=None,
                 random_seed=0, _build=True, **params):
        self.data = np.ascontiguousarray(data, np.float32)
        self.branching = int(branching)
        self.iterations = int(iterations)
        self.leaf_size = int(leaf_size or self.branching)
        self.seed = int(random_seed)
        if _build:
            self._build()

    def _kmeans(self, ids, rng):
        k = min(self.branching, len(ids))
        pts = self.data[ids]
        centers = pts[rng.choice(len(ids), k, replace=False)]
        assign = None
        for _ in range(max(1, self.iterations)):
            d = _l2sq(pts, centers)
            new_assign = d.argmin(1)
            if assign is not None and (new_assign == assign).all():
                break
            assign = new_assign
            for c in range(k):
                m = assign == c
                if m.any():
                    centers[c] = pts[m].mean(0)
        return centers, assign

    def _build(self):
        rng = np.random.default_rng(self.seed)
        self.nodes = []  # dict: centers (k,dim), children list or pts ids

        def build(ids):
            node = len(self.nodes)
            self.nodes.append(None)
            if len(ids) <= self.leaf_size:
                self.nodes[node] = {"pts": ids.astype(np.int32)}
                return node
            centers, assign = self._kmeans(ids, rng)
            children = []
            for c in range(len(centers)):
                sub = ids[assign == c]
                if len(sub):
                    children.append((centers[c], build(sub)))
            if len(children) <= 1:
                self.nodes[node] = {"pts": ids.astype(np.int32)}
                return node
            self.nodes[node] = {
                "centers": np.stack([c for c, _ in children]),
                "children": np.asarray([n for _, n in children], np.int32)}
            return node

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            self.root = build(np.arange(self.data.shape[0]))
        finally:
            sys.setrecursionlimit(old)

    def _search_one(self, q, knn, checks):
        heap = [(0.0, self.root)]
        cand_ids = []
        seen = 0
        while heap and seen < max(checks, knn):
            _, node = heapq.heappop(heap)
            nd = self.nodes[node]
            while "children" in nd:
                d = ((nd["centers"] - q) ** 2).sum(1)
                order = np.argsort(d, kind="stable")
                for j in order[1:]:
                    heapq.heappush(heap, (float(d[j]), int(nd["children"][j])))
                nd = self.nodes[int(nd["children"][order[0]])]
            cand_ids.append(nd["pts"])
            seen += len(nd["pts"])
        cand = np.concatenate(cand_ids) if cand_ids else np.arange(0)
        cand = np.unique(cand)
        d = ((self.data[cand] - q) ** 2).sum(1)
        k = min(knn, len(cand))
        order = np.argsort(d, kind="stable")[:k]
        idx = np.full(knn, -1, np.int32)
        dst = np.full(knn, np.float32(np.inf), np.float32)
        idx[:k] = cand[order]
        dst[:k] = d[order]
        return idx, dst

    def knn_search(self, queries, knn, checks=32):
        q = np.asarray(queries, np.float32)
        idx = np.empty((len(q), knn), np.int32)
        dst = np.empty((len(q), knn), np.float32)
        for i in range(len(q)):
            idx[i], dst[i] = self._search_one(q[i], knn, checks)
        return idx, dst

    def state(self):
        st = {"n_nodes": np.asarray([len(self.nodes)]),
              "root": np.asarray([self.root])}
        for i, nd in enumerate(self.nodes):
            if "pts" in nd:
                st[f"n{i}_pts"] = nd["pts"]
            else:
                st[f"n{i}_centers"] = nd["centers"]
                st[f"n{i}_children"] = nd["children"]
        return st

    @classmethod
    def from_state(cls, data, st, params):
        obj = cls(data, _build=False, **params)
        n = int(st["n_nodes"][0])
        obj.root = int(st["root"][0])
        obj.nodes = []
        for i in range(n):
            if f"n{i}_pts" in st:
                obj.nodes.append({"pts": st[f"n{i}_pts"]})
            else:
                obj.nodes.append({"centers": st[f"n{i}_centers"],
                                  "children": st[f"n{i}_children"]})
        return obj


# --------------------------------------------------------------------------
# Multi-table LSH (lsh_index.h / lsh_table.h) — binary descriptors
# --------------------------------------------------------------------------

class LshIndex:
    """Multi-probe LSH over binary (uint8) descriptors.

    `table_number` tables, each hashing on a random `key_size`-bit subset;
    search probes the query bucket plus all buckets within
    `multi_probe_level` key-bit flips, then Hamming re-ranks candidates
    (lsh_index.h getNeighbors).
    """

    algorithm = FLANN_INDEX_LSH

    def __init__(self, data, table_number=12, key_size=20,
                 multi_probe_level=2, random_seed=0, _build=True, **params):
        self.data = np.ascontiguousarray(data, np.uint8)
        self.table_number = int(table_number)
        self.key_size = int(min(key_size, 30))
        self.multi_probe_level = int(multi_probe_level)
        self.seed = int(random_seed)
        if _build:
            self._build()

    def _bits(self):
        return self.data.shape[1] * 8

    def _keys_for(self, bits_idx, data):
        unpacked = np.unpackbits(data, axis=1)[:, bits_idx]
        weights = (1 << np.arange(len(bits_idx), dtype=np.int64))
        return unpacked.astype(np.int64) @ weights

    def _build(self):
        rng = np.random.default_rng(self.seed)
        self.bit_subsets = [rng.choice(self._bits(), self.key_size,
                                       replace=False).astype(np.int32)
                            for _ in range(self.table_number)]
        self.tables = []
        for bits_idx in self.bit_subsets:
            keys = self._keys_for(bits_idx, self.data)
            tbl = {}
            for i, k in enumerate(keys):
                tbl.setdefault(int(k), []).append(i)
            self.tables.append({k: np.asarray(v, np.int32)
                                for k, v in tbl.items()})

    def _probe_keys(self, key):
        keys = [key]
        if self.multi_probe_level >= 1:
            keys += [key ^ (1 << b) for b in range(self.key_size)]
        if self.multi_probe_level >= 2:
            for b1 in range(self.key_size):
                for b2 in range(b1 + 1, self.key_size):
                    keys.append(key ^ (1 << b1) ^ (1 << b2))
        return keys

    def knn_search(self, queries, knn, checks=32):
        q = np.asarray(queries, np.uint8)
        nq = len(q)
        idx = np.full((nq, knn), -1, np.int32)
        dst = np.full((nq, knn), np.float32(np.inf), np.float32)
        qkeys = [self._keys_for(b, q) for b in self.bit_subsets]
        for i in range(nq):
            cand = []
            for t, tbl in enumerate(self.tables):
                for k in self._probe_keys(int(qkeys[t][i])):
                    hit = tbl.get(k)
                    if hit is not None:
                        cand.append(hit)
            if not cand:
                continue
            cand = np.unique(np.concatenate(cand))
            d = np.unpackbits(self.data[cand] ^ q[i][None, :],
                              axis=1).sum(1)
            k = min(knn, len(cand))
            order = np.argsort(d, kind="stable")[:k]
            idx[i, :k] = cand[order]
            dst[i, :k] = d[order]
        return idx, dst

    def state(self):
        return {"bit_subsets": np.stack(self.bit_subsets),
                "params": np.asarray([self.table_number, self.key_size,
                                      self.multi_probe_level])}

    @classmethod
    def from_state(cls, data, st, params):
        p = st["params"]
        obj = cls(data, table_number=int(p[0]), key_size=int(p[1]),
                  multi_probe_level=int(p[2]), _build=False)
        obj.bit_subsets = [b for b in st["bit_subsets"]]
        obj.tables = []
        for bits_idx in obj.bit_subsets:
            keys = obj._keys_for(bits_idx, obj.data)
            tbl = {}
            for i, k in enumerate(keys):
                tbl.setdefault(int(k), []).append(i)
            obj.tables.append({k: np.asarray(v, np.int32)
                               for k, v in tbl.items()})
        return obj


# --------------------------------------------------------------------------
# cv::flann::Index (miniflann.cpp)
# --------------------------------------------------------------------------

_ALGOS = {
    FLANN_INDEX_LINEAR: LinearIndex,
    FLANN_INDEX_KDTREE: KDTreeIndex,
    FLANN_INDEX_KMEANS: KMeansIndex,
    FLANN_INDEX_LSH: LshIndex,
    # composite/autotuned resolve to kd-tree (the usual autotune winner)
    FLANN_INDEX_COMPOSITE: KDTreeIndex,
    FLANN_INDEX_AUTOTUNED: KDTreeIndex,
}


class Index:
    """cv2.flann_Index-compatible wrapper: build/knnSearch/radiusSearch/
    save/load.  `params` is the cv2 dict form, e.g.
    {"algorithm": FLANN_INDEX_KDTREE, "trees": 4}."""

    def __init__(self, features=None, params=None):
        self._impl = None
        self._params = dict(params or {})
        if features is not None:
            self.build(features, self._params)

    def build(self, features, params):
        self._params = dict(params or {})
        algo = int(self._params.pop("algorithm", FLANN_INDEX_KDTREE))
        cls = _ALGOS.get(algo)
        if cls is None:
            raise ValueError(f"unsupported FLANN algorithm {algo}")
        self._impl = cls(_host(features), **self._params)
        self._algo = algo

    def knnSearch(self, query, knn, params=None):
        checks = int((params or {}).get("checks", 32))
        q = np.atleast_2d(_host(query))
        return self._impl.knn_search(q, int(knn), checks=checks)

    def radiusSearch(self, query, radius, maxResults, params=None):
        idx, dst = self.knnSearch(query, int(maxResults), params)
        mask = dst > radius
        idx[mask] = -1
        dst[mask] = np.inf
        return idx, dst

    def getAlgorithm(self):
        return self._algo

    def save(self, filename):
        st = self._impl.state()
        st["__data__"] = self._impl.data
        st["__algo__"] = np.asarray([self._algo])
        pkeys = sorted(self._params)
        st["__pkeys__"] = np.asarray(
            [f"{k}={self._params[k]}" for k in pkeys], dtype="U64")
        np.savez_compressed(filename, **st)

    def load(self, features, filename):
        if not str(filename).endswith(".npz"):
            filename = str(filename)
        with np.load(filename, allow_pickle=False) as z:
            st = {k: z[k] for k in z.files}
        self._algo = int(st.pop("__algo__")[0])
        data = st.pop("__data__")
        params = {}
        for kv in st.pop("__pkeys__", []):
            k, v = str(kv).split("=", 1)
            try:
                params[k] = int(v)
            except ValueError:
                params[k] = float(v)
        self._params = params
        if features is not None:
            feats = _host(features)
            if feats.shape == data.shape:
                data = feats
        self._impl = _ALGOS[self._algo].from_state(data, st, params)
        return True
