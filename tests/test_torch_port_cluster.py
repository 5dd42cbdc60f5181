"""PyTorch port: per-pixel HSV KMeans (`cgs_tpu_torch/sandbox/cluster.py`)
against the JAX package's `cgs_tpu/sandbox/cluster.py` on the same numpy
inputs, mirroring tests/test_sandbox.py's clustering cases. The port's
KMeans takes the initial indices that JAX draws with
`jax.random.choice(key, P, (k,), replace=False)`.

Tolerances: HSV within 1e-6 of JAX's and of matplotlib's (f32
arithmetic in another order); KMeans on separated blobs: labels equal,
centroids within 1e-5; `cluster_frames`: target equal, labels equal on
>= 99.9% of pixels (ties between two f32 distances may break apart),
centroids within 1e-4 (f32 sums of 49k pixels in another order).
"""

import gzip
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.sandbox import cluster as jcluster
from cgs_tpu_torch.sandbox import cluster


def _jax_init(seed: int, p: int, k: int) -> np.ndarray:
    """The initial indices JAX's kmeans draws from PRNGKey(seed)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), p, (k,),
                                        replace=False))


def test_rgb_to_hsv_matches_jax_and_matplotlib():
    from matplotlib.colors import rgb_to_hsv as mpl_hsv

    rng = np.random.default_rng(0)
    rgb = rng.random((32, 8, 8, 3)).astype(np.float32)
    # greys (delta 0), black, and ties between the max channels
    rgb[0, 0, :4] = [[0.5, 0.5, 0.5], [0, 0, 0], [0.3, 0.3, 0.1],
                     [0.2, 0.7, 0.7]]
    rgb[0, 1, :3] = [[1, 0, 0.5], [0.1, 1, 0.1], [1, 1, 0]]
    ours = cluster.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jcluster.rgb_to_hsv(jnp.asarray(rgb))), atol=1e-6,
        rtol=0)
    np.testing.assert_allclose(ours, mpl_hsv(rgb), atol=1e-6, rtol=0)


def _blobs(rng, centres, n=200, sd=0.05):
    return np.concatenate([rng.normal(c, sd, (n, 2)) for c in centres]
                          ).astype(np.float32)


@pytest.mark.parametrize("centres,seed", [
    ([(0, 0), (1, 1)], 0),
    ([(0, 0), (1, 1), (0, 1)], 3),
])
def test_kmeans_equals_jax_with_its_draw(centres, seed):
    pts = _blobs(np.random.default_rng(1), centres)
    k = len(centres)
    jc, jl = jcluster.kmeans(jnp.asarray(pts), k, iters=20,
                             key=jax.random.PRNGKey(seed))
    init = _jax_init(seed, len(pts), k)
    tc, tl = cluster.kmeans(torch.from_numpy(pts), k, iters=20,
                            init_idx=init)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                               rtol=0)
    labels = tl.numpy()
    for b in range(k):                  # each blob in one cluster
        assert len(set(labels[b * 200:(b + 1) * 200])) == 1
    assert len(set(labels)) == k


@pytest.mark.parametrize("iters", [1, 5])
def test_kmeans_ties_and_empty_clusters_as_jax(monkeypatch, iters):
    """Two initial centroids on the same point: in the first assignment
    every tie goes to the lower index, so the other cluster is empty and
    keeps its centroid through the first update; both packages agree
    after 1 and 5 iterations."""
    pts = _blobs(np.random.default_rng(2), [(0, 0), (1, 1)], n=50)
    pts[7] = pts[3]
    init = np.array([3, 7, 60])
    tc, tl = cluster.kmeans(torch.from_numpy(pts), 3, iters=iters,
                            init_idx=init)
    if iters == 1:
        np.testing.assert_array_equal(tc.numpy()[1], pts[7])
    monkeypatch.setattr(jax.random, "choice",
                        lambda *a, **k: jnp.asarray(init))
    jc, jl = jcluster.kmeans(jnp.asarray(pts), 3, iters=iters)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=0)


def test_kmeans_default_draw_is_seeded():
    pts = torch.from_numpy(_blobs(np.random.default_rng(4),
                                  [(0, 0), (1, 1)]))
    a = cluster.kmeans(pts, 2, iters=10, seed=5)
    b = cluster.kmeans(pts, 2, iters=10, seed=5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    labels = a[1].numpy()
    assert len(set(labels[:200])) == 1 and labels[0] != labels[200]
    with pytest.raises(ValueError, match="init_idx"):
        cluster.kmeans(pts, 2, init_idx=[0, 1, 2])


def _tree_frames(n=12):
    rng = np.random.default_rng(2)
    x = np.full((n, 64, 64, 3), 40, np.uint8)   # dark background
    x += rng.integers(0, 8, x.shape, dtype=np.uint8)
    y = np.zeros(n)
    y[:n // 2] = 1
    # tree = bright green patch inside the box, only on reward frames
    x[:n // 2, 24:40, 27:37] = (40, 220, 40)
    return x, y


def test_cluster_frames_equals_jax(tmp_path):
    x, y = _tree_frames()
    want = jcluster.cluster_frames(x, y, n_clusters=3, seed=0)
    got = cluster.cluster_frames(x, y, n_clusters=3, seed=0,
                                 init_idx=_jax_init(0, x[..., 0].size, 3),
                                 device="cpu")
    assert got["target"] == want["target"] == got["labels"][0, 30, 30]
    assert (got["labels"] == want["labels"]).mean() >= 0.999
    np.testing.assert_allclose(got["centroids"], want["centroids"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["values"], want["values"], atol=1e-6)
    assert got["layers"].shape == (12, 3, 64, 64)
    assert got["layers"].dtype == np.uint8
    assert (cluster.default_treemask() == jcluster.default_treemask()).all()


def test_pickles_cross_load(tmp_path):
    """Each package's kmeans pickle and gzip cluster layers load in the
    other's layout, with the same contents."""
    x, y = _tree_frames()
    res = cluster.cluster_frames(x, y, n_clusters=3, seed=0, device="cpu")
    for mod, tag in ((cluster, "port"), (jcluster, "jax")):
        mod.save_kmeans(str(tmp_path / f"{tag}.p"), res["centroids"],
                        res["target"])
        mod.save_cluster_layers(str(tmp_path / f"{tag}-3-cluster"),
                                res["layers"])
    loaded = {}
    for tag in ("port", "jax"):
        with open(tmp_path / f"{tag}.p", "rb") as fp:
            cents, target = pickle.load(fp)
        with gzip.open(tmp_path / f"{tag}-3-cluster", "rb") as fp:
            layers = pickle.load(fp)
        loaded[tag] = (np.asarray(cents), int(target), layers)
    for tag, (cents, target, layers) in loaded.items():
        np.testing.assert_array_equal(cents, res["centroids"])
        assert target == res["target"]
        assert layers.dtype == np.uint8
        np.testing.assert_array_equal(layers, res["layers"])
