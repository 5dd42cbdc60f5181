"""PyTorch port: the patch-embedding family
(`cgs_tpu_torch/sandbox/patch_embed.py`, `embed_viz.py`) against the JAX
package's on the same numpy inputs, mirroring tests/test_patch_embed.py.
The port's KMeans runs take the initial indices JAX draws from
`jax.random` (keys `seed` and `seed + 1`).

Tolerances: the GMM's weights, means and variances within 1e-4 relative
(f32 EM in another summation order); with the same pixel clusters, raw
patch histograms exactly equal (integer counts) and l1 / l2 within 1e-6;
the fitted tree-probability table within 1e-6 and the patch labels equal
on >= 99.9% of patches; predictions from a 7-tuple written by either
package equal.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from cgs_tpu.sandbox import patch_embed as jpe
from cgs_tpu_torch.sandbox import patch_embed as pe
from cgs_tpu_torch.sandbox.embed_viz import (
    vis_embed, vis_pixels, vis_white_tree,
)

REL = 1e-4


def _jax_init(seed: int, p: int, k: int) -> np.ndarray:
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), p, (k,),
                                        replace=False))


@pytest.fixture(scope="module")
def tree_nav():
    """Synthetic HSV fused dataset: tree frames carry a distinct-hue
    central bar; nav frames are dark noise."""
    rng = np.random.default_rng(0)
    b = 24
    tree = rng.random((b, 64, 64, 3)).astype(np.float32) * 0.2 + 0.6
    tree[:, 10:54, 26:39, 0] = 0.08
    tree[:, 10:54, 26:39, 1] = 0.9
    nav = rng.random((b, 64, 64, 3)).astype(np.float32) * 0.2
    return tree, np.ones(b), nav, np.zeros(b)


def _inits(x, emb, seed=0, pixel_subsample=10, embed_subsample=5):
    """JAX's two KMeans draws in `PatchEmbedder.fit`."""
    n_pix = len(range(0, x[..., 0].size, pixel_subsample))
    n = (64 - emb.pw) // emb.stride + 1
    n_flat = len(range(0, len(x) * n * n, embed_subsample))
    return (_jax_init(seed, n_pix, emb.embed_dim),
            _jax_init(seed + 1, n_flat, emb.n_cluster))


@pytest.fixture(scope="module")
def fitted(tree_nav, tmp_path_factory):
    """Both packages' embedders fitted on the same fused set, the
    port's from JAX's initial draws, and their 7-tuples."""
    tree, rew, nav, navy = tree_nav
    d = tmp_path_factory.mktemp("embed")
    jemb = jpe.create_patch_embedding_clusters(
        tree, rew, nav, navy, str(d / "jax.pickle"), embed_dim=8,
        n_clusters=8, n_samples=16, patch_width=10, stride=2)
    x, _ = pe.fuse_datasets(tree, rew, nav, navy, 16)
    gi, pi = _inits(x, jemb)
    temb = pe.create_patch_embedding_clusters(
        tree, rew, nav, navy, str(d / "port.pickle"), embed_dim=8,
        n_clusters=8, n_samples=16, patch_width=10, stride=2,
        gmm_init_idx=gi, patch_init_idx=pi, device="cpu")
    return jemb, temb, d, x


def test_gmm_equals_jax_with_its_draw():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(0, 0.05, (200, 2)),
                          rng.normal(1, 0.05, (200, 2))]
                         ).astype(np.float32)
    want = jpe.gmm_fit(pts, 2, seed=0)
    got = pe.gmm_fit(pts, 2, seed=0, init_idx=_jax_init(0, 400, 2),
                     device="cpu")
    for k in ("weights", "means", "vars"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=0)
    lab = pe.gmm_assign(got, pts, device="cpu").numpy()
    np.testing.assert_array_equal(lab, np.asarray(jpe.gmm_assign(want, pts)))
    assert len(set(lab[:200])) == 1 and lab[0] != lab[-1]
    assert np.isclose(got["weights"].sum(), 1.0, atol=1e-5)


def test_small_helpers_equal_jax(tree_nav):
    for kw in ({}, {"hue": True}, {"hsv": True}):
        assert pe.channels_for(**kw) == jpe.channels_for(**kw)
        assert pe.embed_data_args(**kw) == jpe.embed_data_args(**kw)
    tree, rew, nav, navy = tree_nav
    rew = rew.copy()
    rew[:4] = 0.0
    for got, want in zip(pe.fuse_datasets(tree, rew, nav, navy, 8, seed=3),
                         jpe.fuse_datasets(tree, rew, nav, navy, 8, seed=3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm", ["raw", "l1", "l2"])
def test_embed_batch_equals_jax_given_pixel_clusters(fitted, norm):
    jemb, _, _, x = fitted
    j = jpe.PatchEmbedder(embed_dim=8, n_cluster=8, norm=norm,
                          pixel_clusters=jemb.pixel_clusters)
    t = pe.PatchEmbedder(embed_dim=8, n_cluster=8, norm=norm,
                         pixel_clusters=jemb.pixel_clusters, device="cpu")
    jf, jshape = j.embed_batch(x[:5])
    tf, tshape = t.embed_batch(x[:5])
    assert tshape == jshape == (5, 28, 28, 8)
    if norm == "raw":
        np.testing.assert_array_equal(tf, jf)
        assert (tf.sum(-1) == 100).all()        # pw^2 pixels a patch
    else:
        np.testing.assert_allclose(tf, jf, atol=1e-6, rtol=0)


def test_fit_equals_jax(fitted):
    """Same initial draws: the pixel GMM, the patch centroids, the
    4-column tree-probability table and the patch labels."""
    jemb, temb, _, x = fitted
    for k in ("weights", "means", "vars"):
        np.testing.assert_allclose(temb.pixel_clusters[k],
                                   jemb.pixel_clusters[k], rtol=REL, atol=0)
    np.testing.assert_allclose(temb.patch_embed_cluster_tree_probs,
                               jemb.patch_embed_cluster_tree_probs,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(temb.patch_embed_clusters,
                               jemb.patch_embed_clusters, rtol=REL,
                               atol=1e-4)
    probs = temb.patch_embed_cluster_tree_probs
    assert probs.shape == (8, 4) and np.isclose(probs[:, 2].max(), 1.0)
    assert probs[:, 3].sum() <= 1.0 + 1e-6
    tp, tl = temb.predict_batch(x[:6])
    jp, jl = jemb.predict_batch(x[:6])
    assert (tl == jl).mean() >= 0.999
    assert tp.shape == tl.shape == (6, 28, 28) and tp.dtype == np.float32
    np.testing.assert_array_equal(
        temb.patch_label_to_color(0), jemb.patch_label_to_color(0))


def test_embed_tuple_loads_both_ways(fitted, tree_nav):
    """A 7-tuple written by either package loads in the other (n_cluster
    restored from the centroid count) and predicts as its writer."""
    jemb, temb, d, _ = fitted
    frames = tree_nav[0][:3]
    for path, writer in ((d / "jax.pickle", jemb), (d / "port.pickle", temb)):
        port = pe.PatchEmbedder(n_cluster=100, device="cpu"
                                ).load_embed_tuple(str(path))
        jax_ = jpe.PatchEmbedder(n_cluster=100).load_embed_tuple(str(path))
        assert port.n_cluster == jax_.n_cluster == 8
        assert (port.embed_dim, port.pw, list(port.channels), port.norm) \
            == (jax_.embed_dim, jax_.pw, list(jax_.channels), jax_.norm)
        want_p, want_l = writer.predict_batch(frames)
        for emb in (port, jax_):
            p, lab = emb.predict_batch(frames)
            assert (lab == want_l).mean() >= 0.999
            np.testing.assert_allclose(p[lab == want_l],
                                       want_p[lab == want_l], atol=0)


def test_visualisers_write_their_files(fitted, tree_nav, tmp_path):
    _, temb, _, _ = fitted
    tree, _, nav, _ = tree_nav
    frames = np.concatenate([tree[:6], nav[:6]])
    video = vis_embed(temb, frames, str(tmp_path), "res")
    assert video.endswith("res.mp4") and os.path.getsize(video) > 0
    out = vis_white_tree(temb, frames, str(tmp_path), "wt", ref_index=0)
    assert os.path.getsize(out["video"]) > 0
    assert len(out["swatches"]) == 3 and len(out["labelset"]) == 3
    assert Image.open(tmp_path / "wt" / "0.png").size == (5 * 64, 64)
    png = vis_pixels((tree[:4] * 255).astype(np.uint8),
                     str(tmp_path / "pix.png"), n_components=5,
                     subsample=50, device="cpu")
    assert os.path.getsize(png) > 0


def test_vis_pixels_names_matplotlib_when_absent(monkeypatch, tmp_path):
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        vis_pixels(np.zeros((1, 64, 64, 3), np.uint8),
                   str(tmp_path / "p.png"), device="cpu")
    assert not (tmp_path / "p.png").exists()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.gmm_fit(np.zeros((10, 2), np.float32), 2)
    params = {"means": np.zeros((2, 2)), "vars": np.ones((2, 2)),
              "weights": np.full(2, 0.5)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.gmm_assign(params, np.zeros((10, 2), np.float32))


def test_gmm_assign_runs_where_asked(monkeypatch, tmp_path):
    """numpy points go to the device asked for, a tensor stays on its
    own; vis_pixels assigns on the device it fits on."""
    pts = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    params = {"means": pts, "vars": np.ones((2, 2)),
              "weights": np.full(2, 0.5)}
    for points in (pts, torch.from_numpy(pts)):
        lab = pe.gmm_assign(params, points, device="cpu")
        assert lab.device.type == "cpu" and lab.tolist() == [0, 1]
    seen = []
    real = pe.gmm_assign

    def spy(params, points, device=None):
        seen.append(device)
        return real(params, points, device=device)

    monkeypatch.setattr(pe, "gmm_assign", spy)
    vis_pixels(np.zeros((1, 64, 64, 3), np.uint8), str(tmp_path / "p.png"),
               n_components=1, subsample=50, device="cpu")
    assert seen == ["cpu"]
