"""Per-pixel HSV KMeans clustering (PyTorch port of
`cgs_tpu/sandbox/cluster.py`; reference `cluster`,
TrainHandler.py:1995-2141): cluster every pixel of a frame batch in a
scaled (hue, saturation) space, score each cluster by its overlap with
the hand-drawn tree box `treemask[21:42, 25:39]` on reward frames
(TrainHandler.py:2007-2008,2066-2070), and pick the argmax cluster as
the "tree" cluster. The pickles keep the JAX package's layout, so
either package reads the other's files.

KMeans is Lloyd's algorithm in torch on the points' device: each
iteration one (P, D) x (D, K) matmul for the distances (the quadratic
form, never the (P, K, D) difference: at per-pixel scale that is
gigabytes), one argmin, one count and one (K, P) x (P, D) matmul for the
sums. The matmuls run with TF32 off, so f32 means f32 on the card.

Deviation: the JAX package draws the initial centroids with
`jax.random.choice(key, P, (k,), replace=False)`, a stream torch cannot
replay. `kmeans` therefore takes the initial indices (`init_idx`, which
the parity tests take from that same draw); without them it draws k
distinct indices from a CPU `torch.Generator` seeded by `seed`.
"""

from __future__ import annotations

import contextlib
import gzip
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Vectorized RGB->HSV on [0,1] floats (matplotlib.colors
    semantics; the reference round-trips through
    matplotlib.colors.rgb_to_hsv on uint8/255). `%` is torch's
    remainder, with the divisor's sign, as `jnp`'s."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    one = torch.ones_like(delta)
    safe = torch.where(delta == 0, one, delta)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), (h / 6.0) % 1.0)
    s = torch.where(maxc == 0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0, one, maxc))
    return torch.stack([h, s, maxc], dim=-1)


def default_treemask() -> np.ndarray:
    """The hand-drawn tree box (TrainHandler.py:2007-2008)."""
    m = np.zeros((64, 64), np.uint8)
    m[21:42, 25:39] = 1
    return m


@contextlib.contextmanager
def f32_matmul():
    """cuBLAS matmuls in full f32 (TF32 off) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def nearest(points: torch.Tensor, centroids: torch.Tensor,
            sq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The index of each point's nearest centroid by the quadratic form
    ||x||^2 - 2xC^T + ||c||^2, (P,) int64; ties go to the lowest index
    (torch's argmin keeps the first). sq: the points' ||x||^2, (P, 1)."""
    if sq is None:
        sq = torch.sum(points * points, dim=1, keepdim=True)
    d2 = (sq - 2.0 * points @ centroids.T
          + torch.sum(centroids * centroids, dim=1)[None])
    return torch.argmin(d2, dim=1)


def kmeans(points: torch.Tensor, k: int, iters: int = 25,
           init_idx=None, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's KMeans on (P, D) float points, on their device ->
    (centroids (k, D), labels (P,)). The initial centroids are
    points[init_idx] (k distinct indices), else k distinct indices drawn
    from a generator seeded by `seed`. Ties go to the lowest index like
    sklearn; an empty cluster keeps its previous centroid."""
    if init_idx is None:
        gen = torch.Generator().manual_seed(int(seed))
        init_idx = torch.randperm(points.shape[0], generator=gen)[:k]
    init_idx = torch.as_tensor(np.array(init_idx, np.int64),
                               device=points.device)
    if init_idx.shape != (k,):
        raise ValueError(f"init_idx has shape {tuple(init_idx.shape)}, "
                         f"not ({k},)")
    with f32_matmul():
        sq = torch.sum(points * points, dim=1, keepdim=True)
        centroids = points[init_idx]
        for _ in range(iters):
            labels = nearest(points, centroids, sq)
            counts = torch.bincount(labels, minlength=k).to(points.dtype)
            one_hot = torch.nn.functional.one_hot(labels, k).to(points.dtype)
            sums = one_hot.T @ points
            centroids = torch.where(counts[:, None] > 0,
                                    sums / torch.clamp(counts[:, None],
                                                       min=1.0),
                                    centroids)
        return centroids, nearest(points, centroids, sq)


def cluster_frames(x_u8: np.ndarray, y: np.ndarray, n_clusters: int,
                   treemask: np.ndarray | None = None,
                   color: str = "RGB", iters: int = 25,
                   seed: int = 0, init_idx=None, device=None) -> Dict:
    """The reference's per-batch clustering pass, on `device` (default
    cuda).

    x_u8: (B, 64, 64, 3) uint8 frames; y: (B,) binary reward labels.
    Pixels are embedded as (hue, 0.1*saturation)
    (TrainHandler.py:2034-2038: channels [0,1], /255, s *= 0.1), then
    KMeans'd (`init_idx` / `seed` as `kmeans`'s); each cluster's value
    = fraction of its pixels on reward frames that fall inside the tree
    box (TrainHandler.py:2066-2070).

    Returns {labels (B,64,64), layers (B,k,64,64) uint8, values (k,),
    target (int), centroids}."""
    dev = resolve_device(device)
    treemask = default_treemask() if treemask is None else treemask
    x = torch.from_numpy(np.ascontiguousarray(x_u8)).to(dev).float() / 255.0
    hsv = rgb_to_hsv(x) if color == "RGB" else x
    pixels = hsv[..., :2].reshape(-1, 2).clone()
    pixels[:, 1] *= 0.1

    centroids, flat_labels = kmeans(pixels, n_clusters, iters=iters,
                                    init_idx=init_idx, seed=seed)
    labels = flat_labels.cpu().numpy().reshape(x_u8.shape[:-1])

    rew = np.asarray(y) == 1
    tm = treemask.astype(np.float64)
    values = []
    for c in range(n_clusters):
        sel = labels[rew] == c
        denom = sel.sum()
        # reference divides unguarded (nan for an empty cluster);
        # quirk policy: same ranking, no nan
        values.append(float((sel * tm).sum() / max(denom, 1)))
    layers = np.stack([(labels == c) for c in range(n_clusters)],
                      axis=1).astype(np.uint8)
    return {
        "labels": labels,
        "layers": layers,
        "values": np.asarray(values),
        "target": int(np.argmax(values)),
        "centroids": centroids.cpu().numpy(),
    }


def save_kmeans(path: str, centroids: np.ndarray, target: int) -> None:
    """(kmeans, targetcluster) pickle (TrainHandler.py:2108-2110);
    the centroid array stands in for an sklearn estimator."""
    with open(path, "wb") as fp:
        pickle.dump((np.asarray(centroids), int(target)), fp)


def save_cluster_layers(path: str, layers: np.ndarray) -> None:
    """Gzip per-frame boolean cluster layers, the `-clustersave`
    dataset the old `segment` path consumed via `-clustercritic`
    (TrainHandler.py:2116-2141,1910-1912)."""
    with gzip.GzipFile(path, "wb") as fp:
        pickle.dump(np.asarray(layers, np.uint8), fp)
