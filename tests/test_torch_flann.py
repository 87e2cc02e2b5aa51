"""The port's FLANN indexes and FlannBasedMatcher against opencv_tpu on the
CPU.  ``opencv_tpu_torch/flann`` is the JAX package's host numpy, copied,
so every result is held exactly: ``array_equal`` on indices and on the
float32 distances (the same numpy operations in the same order give the
same rounding), and equal DMatch lists.  An index saved by either package
loads into the other and searches to the same answers."""

import numpy as np
import pytest
import torch

from common import cv2

import opencv_tpu as jcv
import opencv_tpu_torch as tcv


def _dataset(n=600, dim=32, nq=40, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, dim)).astype(np.float32)
    q = data[:nq] + rng.normal(scale=0.01, size=(nq, dim)).astype(np.float32)
    return data, q


def _binary(n=500, nb=32, nq=30, seed=2):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, nb), dtype=np.uint8)
    q = data[:nq].copy()
    q[np.arange(nq), rng.integers(0, nb, nq)] ^= 1
    return data, q


# (index parameters, search parameters, binary data)
INDEXES = {
    "linear": ({"algorithm": 0}, {}, False),
    "kdtree": ({"algorithm": 1, "trees": 4}, {"checks": 32}, False),
    "kdtree_seeded": ({"algorithm": 1, "trees": 2, "random_seed": 7}, {"checks": 64}, False),
    "kmeans": ({"algorithm": 2, "branching": 16}, {"checks": 64}, False),
    "lsh": ({"algorithm": 6, "table_number": 6, "key_size": 12, "multi_probe_level": 1}, {},
            True),
    "autotuned": ({"algorithm": 255}, {"checks": 16}, False),
}


def _data_for(binary):
    return _binary() if binary else _dataset()


def _same_search(a, b):
    (ia, da), (ib, db) = a, b
    assert ia.dtype == ib.dtype and da.dtype == db.dtype
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)


@pytest.mark.parametrize("name", list(INDEXES))
def test_index_equals_opencv_tpu(name):
    params, search, binary = INDEXES[name]
    data, q = _data_for(binary)
    ours = tcv.flann_Index(torch.from_numpy(data), params)
    ref = jcv.flann_Index(data, params)
    assert ours.getAlgorithm() == ref.getAlgorithm()
    for k in (1, 3):
        _same_search(ours.knnSearch(torch.from_numpy(q), k, search), ref.knnSearch(q, k, search))
    _same_search(ours.knnSearch(q[0], 2, search), ref.knnSearch(q[0], 2, search))
    r = 40.0 if binary else 2.0
    _same_search(ours.radiusSearch(q, r, 5, search), ref.radiusSearch(q, r, 5, search))


@pytest.mark.parametrize("name", ["kdtree", "kmeans", "lsh", "linear"])
def test_saved_index_carries_between_the_packages(name, tmp_path):
    """opencv_tpu.flann.Index.save → the port's Index.load (and back)
    gives the same knnSearch; the port reads the .npz itself."""
    params, search, binary = INDEXES[name]
    data, q = _data_for(binary)
    ref = jcv.flann_Index(data, params)
    want = ref.knnSearch(q, 2, search)
    f = str(tmp_path / "ref.npz")
    ref.save(f)
    ours = tcv.flann_Index()
    assert ours.load(torch.from_numpy(data), f)
    assert ours.getAlgorithm() == ref.getAlgorithm()
    _same_search(ours.knnSearch(q, 2, search), want)
    ours2 = tcv.flann_Index()
    ours2.load(None, f)
    _same_search(ours2.knnSearch(q, 2, search), want)
    g = str(tmp_path / "ours.npz")
    ours.save(g)
    back = jcv.flann_Index()
    back.load(data, g)
    _same_search(back.knnSearch(q, 2, search), want)


def test_index_constants_and_classes():
    for name in ("FLANN_INDEX_LINEAR", "FLANN_INDEX_KDTREE", "FLANN_INDEX_KMEANS",
                 "FLANN_INDEX_COMPOSITE", "FLANN_INDEX_KDTREE_SINGLE", "FLANN_INDEX_HIERARCHICAL",
                 "FLANN_INDEX_LSH", "FLANN_INDEX_SAVED", "FLANN_INDEX_AUTOTUNED"):
        assert getattr(tcv.flann, name) == getattr(jcv.flann, name), name
    for name in ("Index", "LinearIndex", "KDTreeIndex", "KMeansIndex", "LshIndex"):
        assert getattr(tcv.flann, name).__name__ == getattr(jcv.flann, name).__name__
    assert tcv.flann_Index is tcv.flann.Index
    with pytest.raises(ValueError):
        tcv.flann_Index(np.zeros((4, 2), np.float32), {"algorithm": 99})


def _sift_like(n, seed):
    """128-dim f32 rows of small non-negative integers, the range and
    sparsity of SIFT descriptors."""
    rng = np.random.default_rng(seed)
    d = np.floor(rng.gamma(0.6, 25.0, (n, 128))).clip(0, 255)
    return d.astype(np.float32)


def _dmatches(lists):
    return [[(m.queryIdx, m.trainIdx, m.imgIdx, m.distance) for m in row] for row in lists]


def test_flann_matcher_kdtree_equals_opencv_tpu():
    """The default matcher (4 kd-trees, 32 checks, squared L2 rooted) on
    SIFT-like f32 descriptors, given as tensors to the port."""
    rng = np.random.default_rng(3)
    d1 = _sift_like(300, 1)
    d2 = np.concatenate([d1[:200] + rng.integers(-3, 4, (200, 128)), _sift_like(150, 2)])
    d2 = d2.clip(0, 255).astype(np.float32)
    t1, t2 = torch.from_numpy(d1), torch.from_numpy(d2)
    ours, ref = tcv.FlannBasedMatcher(), jcv.FlannBasedMatcher()
    assert _dmatches(ours.knnMatch(t1, t2, 2)) == _dmatches(ref.knnMatch(d1, d2, 2))
    assert _dmatches([ours.match(t1, t2)]) == _dmatches([ref.match(d1, d2)])
    assert (_dmatches(ours.radiusMatch(t1, t2, 60.0))
            == _dmatches(ref.radiusMatch(d1, d2, 60.0)))
    # add/train semantics: the index is the stacked training set
    ours, ref = tcv.FlannBasedMatcher_create(), jcv.FlannBasedMatcher_create()
    for m, a, b in ((ours, t2[:100], [t2[100:]]), (ref, d2[:100], [d2[100:]])):
        m.add(a)
        m.add(b)
        m.train()
    assert _dmatches(ours.knnMatch(t1, None, 3)) == _dmatches(ref.knnMatch(d1, None, 3))
    good = [p for p in ours.knnMatch(t1, t2, 2) if p[0].distance < 0.7 * p[1].distance]
    assert len(good) >= 150


def test_flann_matcher_lsh_on_orb_descriptors():
    """LSH over the port's ORB descriptors of two views of one scene, the
    same DMatch lists as opencv_tpu's matcher on the same descriptors."""
    rng = np.random.default_rng(4)
    img = cv2.GaussianBlur(rng.integers(0, 256, (240, 320), np.uint8), (0, 0), 1.5)
    M = cv2.getRotationMatrix2D((160, 120), 8, 1.0)
    img2 = cv2.warpAffine(img, M, (320, 240))
    orb = tcv.ORB_create(nfeatures=300)
    _, d1 = orb.detectAndCompute(img, None)
    _, d2 = orb.detectAndCompute(img2, None)
    d1, d2 = np.asarray(d1), np.asarray(d2)
    assert d1.dtype == np.uint8 and len(d1) > 100 and len(d2) > 100
    params = {"algorithm": 6, "table_number": 6, "key_size": 12, "multi_probe_level": 1}
    ours = tcv.FlannBasedMatcher(params, {"checks": 32})
    ref = jcv.FlannBasedMatcher(params, {"checks": 32})
    got = ours.knnMatch(torch.from_numpy(d1), torch.from_numpy(d2), 2)
    assert _dmatches(got) == _dmatches(ref.knnMatch(d1, d2, 2))
    # Hamming distances, unrooted; a kd-tree matcher takes u8 rows as f32
    bf = tcv.BFMatcher(tcv.NORM_HAMMING)
    dist = {(m.queryIdx, m.trainIdx): m.distance for row in bf.knnMatch(d1, d2, 2) for m in row}
    for row in got:
        for m in row:
            if (m.queryIdx, m.trainIdx) in dist:
                assert m.distance == dist[(m.queryIdx, m.trainIdx)]
    kd = tcv.FlannBasedMatcher().knnMatch(d1[:20], d2, 1)
    assert _dmatches(kd) == _dmatches(jcv.FlannBasedMatcher().knnMatch(d1[:20], d2, 1))


@pytest.mark.parametrize("kind", ["FlannBased", "BruteForce", "BruteForce-L1",
                                  "BruteForce-Hamming", "BruteForce-Hamming(2)",
                                  "BruteForce-SL2", 0, 1, 2, 3, 5, 9])
def test_descriptor_matcher_create_equals_opencv_tpu(kind):
    ours, ref = tcv.DescriptorMatcher_create(kind), jcv.DescriptorMatcher_create(kind)
    assert type(ours).__name__ == type(ref).__name__
    if isinstance(ref, jcv.BFMatcher):
        assert ours.norm_type == ref.norm_type and ours.cross_check == ref.cross_check
    else:
        assert ours.index_params == ref.index_params
        assert ours.search_params == ref.search_params
