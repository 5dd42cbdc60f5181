"""Patch-embedding clusters with per-cluster tree probability (PyTorch
port of `cgs_tpu/sandbox/patch_embed.py`; reference
`create_patch_embedding_clusters`, TrainHandler.py:2161-2291, and the
`PatchEmbedder` consumer surface used at
TrainHandler.py:2173-2176,2232-2234,2283-2288,2355-2357).

The upstream `isy_minerl.segm.PatchEmbedder` is absent from the
reference repo (TrainHandler.py:27 imports it and fails); the JAX
package reconstructs it from its call surface, and this module ports
that reconstruction: a diagonal GMM over (sub-sampled) pixel colours
(`pixel_clusters`), per-patch embeddings that are the histogram of the
patch's pixels over the `embed_dim` GMM components (`embed_batch`),
KMeans over the patch embeddings (`patch_embed_clusters`), the 4-column
tree-probability table, `predict_batch`, and the 7-tuple pickle, which
either package reads from the other.

Everything runs in torch on the embedder's device (default cuda): EM as
a loop of (P, D) x (D, E) matmuls, with `sandbox/cluster.py:kmeans` for
the initial means; the hard assignment; the per-patch histogram as a box
sum (`F.avg_pool2d(..., divisor_override=1)`: window pw, stride 2, no
padding, as JAX's `lax.reduce_window` VALID sum) over channels-first
one-hot planes, so the raw counts are exact integers; frames go through
in batches of `EMBED_BATCH`. The matmuls run with TF32 off.

Deviation: JAX draws KMeans's initial centroids from `jax.random`
(keys `seed` for the GMM's, `seed + 1` for the patch KMeans'). `gmm_fit`
and `PatchEmbedder.fit` take those initial indices explicitly; without
them each KMeans draws from a torch generator seeded by the same seed
(`cluster.kmeans`).
"""

from __future__ import annotations

import math
import pickle
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.sandbox.cluster import f32_matmul, kmeans, nearest

_VAR_FLOOR = 1e-6
EMBED_BATCH = 128     # frames a one-hot pass holds (E x 64 x 64 f32 each)


# ---------------------------------------------------------------------------
# Diagonal-covariance GMM (sklearn GMM stand-in, TrainHandler.py:2230)
# ---------------------------------------------------------------------------

def _quad(p: torch.Tensor, means: torch.Tensor, var: torch.Tensor):
    """(P, E) ||x - mu_e||^2 weighted by 1/var_e, as the expansion
    x^2.inv - 2 x.(mu*inv) + mu^2.inv, and the (E,) log-determinants."""
    inv = 1.0 / var
    quad = (p ** 2) @ inv.T - 2.0 * (p @ (means * inv).T)
    quad = quad + torch.sum(means ** 2 * inv, dim=1)
    return quad, torch.sum(torch.log(var), dim=1)


def _gmm_em(points: torch.Tensor, n_components: int, iters: int,
            init_idx=None, seed: int = 0) -> Dict[str, torch.Tensor]:
    """EM for a diagonal GMM on (P, D) points, on their device. Returns
    {'weights' (E,), 'means' (E, D), 'vars' (E, D)}. Means initialise
    from KMeans (like sklearn's default init; its initial centroids
    points[init_idx], else drawn from `seed`), variances from the data's
    population variance (`correction=0`, `jnp.var`'s)."""
    p = points.float()
    means0, _ = kmeans(p, n_components, iters=10, init_idx=init_idx,
                       seed=seed)
    var0 = torch.clamp(torch.var(p, dim=0, correction=0), min=_VAR_FLOOR)
    weights = torch.full((n_components,), 1.0 / n_components,
                         device=p.device)
    means = means0
    var = var0.expand(n_components, p.shape[1])
    d = p.shape[1]
    with f32_matmul():
        for _ in range(iters):
            quad, logdet = _quad(p, means, var)
            lp = (-0.5 * (quad + logdet + d * math.log(2 * math.pi))
                  + torch.log(weights))
            resp = torch.softmax(lp, dim=1)                   # (P, E)
            nk = torch.clamp(resp.sum(dim=0), min=1e-10)      # (E,)
            means = (resp.T @ p) / nk[:, None]
            ex2 = (resp.T @ (p ** 2)) / nk[:, None]
            var = torch.clamp(ex2 - means ** 2, min=_VAR_FLOOR)
            weights = nk / p.shape[0]
    return {"weights": weights, "means": means, "vars": var}


def gmm_fit(points: np.ndarray, n_components: int, iters: int = 30,
            seed: int = 0, init_idx=None, device=None
            ) -> Dict[str, np.ndarray]:
    """Fit a diagonal GMM on `device` (default cuda); returns numpy
    params."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    out = _gmm_em(pts, n_components, iters, init_idx, seed)
    return {k: v.cpu().numpy() for k, v in out.items()}


def gmm_assign(params: Dict[str, np.ndarray], points,
               device=None) -> torch.Tensor:
    """Hard component assignment (argmax posterior) of (P, D) points: a
    tensor's on its own device, other points on `device` (default the
    card, as `resolve_device`)."""
    p = (points if isinstance(points, torch.Tensor)
         else torch.as_tensor(np.asarray(points),
                              device=resolve_device(device))).float()
    means, var, w = (torch.as_tensor(np.array(params[k], np.float32),
                                     device=p.device)
                     for k in ("means", "vars", "weights"))
    with f32_matmul():
        quad, logdet = _quad(p, means, var)
    return torch.argmax(-0.5 * (quad + logdet) + torch.log(w), dim=1)


# ---------------------------------------------------------------------------
# PatchEmbedder
# ---------------------------------------------------------------------------

def channels_for(hue: bool = False, hsv: bool = False) -> List[int]:
    """Channel selection (TrainHandler.py:2171):
    -hue -> [0], -hsv -> [0,1,2], default -> [0,1] (hue+saturation)."""
    return [0] if hue else ([0, 1, 2] if hsv else [0, 1])


@dataclass
class PatchEmbedder:
    """Reconstruction of the missing upstream PatchEmbedder (see module
    docstring). Frames are HSV floats in [0, 1] shaped (B, H, W, 3),
    matching every call site (the reference converts with
    matplotlib rgb_to_hsv before embedding, TrainHandler.py:2224).
    `device`: where the embedding and the fits run (None: cuda)."""

    embed_dim: int = 100          # --embed-dim (TrainHandler.py:4004)
    n_cluster: int = 100          # --embed-cluster (:4005)
    channels: Sequence[int] = (0, 1)
    pw: int = 10                  # --embed-patch-width (:4007)
    stride: int = 2               # hardcoded (TrainHandler.py:2166)
    norm: str = "raw"             # --embed-norm (:4009)

    pixel_clusters: Dict[str, np.ndarray] | None = None
    patch_embed_clusters: np.ndarray | None = None   # (K, E) centroids
    patch_embed_cluster_tree_probs: np.ndarray | None = None  # (K, 4)
    device: object = None

    # ---- embedding -------------------------------------------------

    @property
    def w(self) -> int:
        """Patch width (saved in the embed tuple,
        TrainHandler.py:2287)."""
        return self.pw

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) HSV floats on the device -> (B, ph, pwn, E)."""
        e = self.embed_dim
        sel = x[..., list(self.channels)]
        labels = gmm_assign(self.pixel_clusters,
                            sel.reshape(-1, len(self.channels)))
        # one-hot planes channels-first; the box sum of each (pw, pw)
        # window, stride `stride`, counts each patch's pixels per
        # component exactly
        one_hot = F.one_hot(labels.view(x.shape[:3]), e).float()
        counts = F.avg_pool2d(one_hot.permute(0, 3, 1, 2), self.pw,
                              stride=self.stride, divisor_override=1)
        counts = counts.permute(0, 2, 3, 1)
        if self.norm == "l1":
            counts = counts / torch.clamp(counts.sum(-1, keepdim=True),
                                          min=1.0)
        elif self.norm == "l2":
            counts = counts / torch.clamp(
                torch.linalg.norm(counts, dim=-1, keepdim=True), min=1e-6)
        return counts

    def embed_batch(self, x: np.ndarray
                    ) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """(flat_embeds (B*ph*pwn, E), pshape (B, ph, pwn, E)) —
        the TrainHandler.py:2234 contract."""
        flat, pshape = self._embed_device(x)
        return flat.cpu().numpy(), pshape

    def _embed_device(self, x: np.ndarray):
        if self.pixel_clusters is None:
            raise RuntimeError("fit the pixel GMM first")
        dev = resolve_device(self.device)
        x = np.asarray(x, np.float32)
        grids = [self._embed(torch.from_numpy(
            np.ascontiguousarray(x[i:i + EMBED_BATCH])).to(dev))
            for i in range(0, len(x), EMBED_BATCH)]
        grid = torch.cat(grids)
        return grid.reshape(-1, self.embed_dim), tuple(grid.shape)

    # ---- fitting (TrainHandler.py:2226-2281) -----------------------

    def fit(self, x: np.ndarray, y: np.ndarray, seed: int = 0,
            pixel_subsample: int = 10, embed_subsample: int = 5,
            gmm_init_idx=None, patch_init_idx=None) -> np.ndarray:
        """The create_patch_embedding_clusters math on a fused
        (frames, binary tree label) dataset. Returns the (K, 4)
        tree-probability table and stores all fitted state.
        gmm_init_idx / patch_init_idx: the initial indices of the GMM's
        KMeans and of the patch KMeans (JAX draws them with keys `seed`
        and `seed + 1`); without them each draws from its seed.

        Column semantics (TrainHandler.py:2270-2281):
          0: cluster positives / B      1: cluster size / B
          2: precision (max-normalized) 3: recall
        (columns 0/1 divide by len(labels) == the leading batch axis,
        a reference quirk preserved verbatim)."""
        dev = resolve_device(self.device)
        pixels = x.reshape(-1, x.shape[-1])[::pixel_subsample]
        pixels = pixels[:, list(self.channels)]
        self.pixel_clusters = gmm_fit(pixels, self.embed_dim, seed=seed,
                                      init_idx=gmm_init_idx, device=dev)

        flat, pshape = self._embed_device(x)
        centroids, _ = kmeans(flat[::embed_subsample].contiguous(),
                              self.n_cluster, init_idx=patch_init_idx,
                              seed=seed + 1)
        self.patch_embed_clusters = centroids.cpu().numpy()
        flat_labels = self._assign_patches(flat).cpu().numpy()
        labels = flat_labels.reshape(pshape[0:3])

        # central-box GT on the patch grid (TrainHandler.py:2263-2269;
        # the /10 vs /3 axis mix is verbatim)
        shape = pshape[:3]
        gt = np.zeros(shape)
        xmid = shape[2] / 2
        ymid = shape[1] / 2
        xslice = slice(int(xmid - shape[1] / 10),
                       math.ceil(xmid + shape[1] / 10))
        yslice = slice(int(ymid - shape[2] / 3),
                       math.ceil(ymid + shape[2] / 3))
        gt[np.asarray(y) == 1, yslice, xslice] = 1
        flat_gt = gt.reshape(-1)

        # per-cluster sums of 0/1 values in float64: exact, so equal to
        # the reference's loop over clusters
        num_label = np.bincount(flat_labels, minlength=self.n_cluster
                                ).astype(np.float64)
        num_pos = np.bincount(flat_labels, weights=flat_gt,
                              minlength=self.n_cluster)
        num_all_pos = np.sum(flat_gt)
        tree_probs = np.zeros((self.n_cluster, 4))
        tree_probs[:, 0] = num_pos / len(labels)
        tree_probs[:, 1] = num_label / len(labels)
        # reference divides unguarded (nan for an empty cluster);
        # quirk policy (SURVEY §7.3): same ranking, no nan
        tree_probs[:, 2] = num_pos / np.maximum(num_label, 1)
        tree_probs[:, 3] = num_pos / max(num_all_pos, 1)
        tree_probs[:, 2] /= max(np.max(tree_probs[:, 2]), 1e-12)
        self.patch_embed_cluster_tree_probs = tree_probs
        return tree_probs

    def _assign_patches(self, flat_embeds: torch.Tensor) -> torch.Tensor:
        c = torch.as_tensor(self.patch_embed_clusters,
                            device=flat_embeds.device)
        with f32_matmul():
            return nearest(flat_embeds, c)

    # ---- prediction (TrainHandler.py:2356) -------------------------

    def predict_batch(self, x: np.ndarray, verbose: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(probs (B, ph, pwn), labels (B, ph, pwn)): per-patch
        normalized tree precision and patch-cluster id."""
        if self.patch_embed_clusters is None:
            raise RuntimeError("fit the patch clusters first")
        flat, pshape = self._embed_device(x)
        labels = self._assign_patches(flat).cpu().numpy().reshape(
            pshape[0:3])
        probs = self.patch_embed_cluster_tree_probs[:, 2][labels]
        return probs.astype(np.float32), labels

    def convert_treshold(self, t: float) -> float:
        """TrainHandler.py:2316. tree_probs[:, 2] is max-normalized in
        fit(), so a threshold on [0, 1] passes through unchanged (the
        upstream module is absent; this is the shape-consistent
        reconstruction)."""
        return float(t)

    def patch_label_to_color(self, label: int,
                             top: int = 3) -> np.ndarray:
        """Top pixel-cluster colors of a patch cluster
        (TrainHandler.py:2346-2350): the centroid histogram's heaviest
        GMM components rendered as an HSV swatch strip, (16, 16*top, 3)
        uint8 (missing channels filled with 1.0)."""
        from cgs_tpu_torch.utils.colors import hsv_to_rgb

        centroid = self.patch_embed_clusters[label]
        order = np.argsort(centroid)[::-1][:top]
        swatches = []
        for comp in order:
            mean = self.pixel_clusters["means"][comp]
            hsv = np.ones(3, np.float32)
            for i, ch in enumerate(self.channels):
                hsv[ch] = mean[i]
            rgb = hsv_to_rgb(np.clip(hsv, 0, 1))
            swatches.append(np.broadcast_to(rgb, (16, 16, 3)))
        strip = np.concatenate(swatches, axis=1)
        return (255 * strip).astype(np.uint8)

    # ---- persistence (TrainHandler.py:2287-2288) -------------------

    def save_embed_tuple(self, path: str) -> None:
        """The 7-tuple pickle layout of TrainHandler.py:2287-2288:
        (embed_clusters, tree_probs, embed_dim, pixel_clusters, w,
        channels, norm) — estimator objects stored as plain arrays."""
        with open(path, "wb") as fp:
            pickle.dump((self.patch_embed_clusters,
                         self.patch_embed_cluster_tree_probs,
                         self.embed_dim, self.pixel_clusters, self.w,
                         list(self.channels), self.norm), fp)

    def load_embed_tuple(self, path: str) -> "PatchEmbedder":
        with open(path, "rb") as fp:
            (clusters, probs, embed_dim, pixel_clusters, w, channels,
             norm) = pickle.load(fp)
        self.patch_embed_clusters = np.asarray(clusters)
        self.patch_embed_cluster_tree_probs = np.asarray(probs)
        self.embed_dim = int(embed_dim)
        # the 7-tuple doesn't carry n_cluster explicitly; it IS the
        # centroid count (load must not keep the constructor default)
        self.n_cluster = int(self.patch_embed_clusters.shape[0])
        self.pixel_clusters = {k: np.asarray(v)
                               for k, v in pixel_clusters.items()}
        self.pw = int(w)
        self.channels = list(channels)
        self.norm = norm
        return self


# ---------------------------------------------------------------------------
# The create_patch_embedding_clusters driver (TrainHandler.py:2161-2291)
# ---------------------------------------------------------------------------

def embed_data_args(embed_cluster: int = 100, embed_dim: int = 100,
                    embed_train_samples: int = 700, delay: int = 0,
                    embed_pos_threshold: float = 0.9,
                    embed_patch_width: int = 10, hue: bool = False,
                    hsv: bool = False, embed_norm: str = "raw") -> str:
    """The fingerprint filename stem (TrainHandler.py:205-208)."""
    color = "-hue" if hue else ("-hsv" if hsv else "-hs")
    return (f"cl{embed_cluster}-dim{embed_dim}-ds{embed_train_samples}"
            f"-dl{delay}-th{embed_pos_threshold}-pw{embed_patch_width}"
            f"{color}-{embed_norm}")


def fuse_datasets(tree_x: np.ndarray, tree_rewards: np.ndarray,
                  nav_x: np.ndarray, nav_y: np.ndarray,
                  n_samples: int, pos_threshold: float = 0.9,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse high-reward treechop frames (label 1) with navigation
    negatives (TrainHandler.py:2192-2200). Inputs/outputs are HSV
    floats in [0, 1]; tree_rewards is the discounted reward row
    (reward_idx 4, TrainHandler.py:2169)."""
    rng = np.random.default_rng(seed)
    high = tree_rewards >= pos_threshold
    tx = tree_x[high]
    navsel = rng.integers(len(nav_x), size=n_samples)
    treesel = rng.integers(len(tx), size=n_samples)
    x = np.concatenate((tx[treesel], nav_x[navsel]), axis=0)
    y = np.concatenate((np.ones(n_samples), nav_y[navsel]), axis=0)
    return x, y


def create_patch_embedding_clusters(
        tree_x: np.ndarray, tree_rewards: np.ndarray,
        nav_x: np.ndarray, nav_y: np.ndarray, out_path: str,
        embed_dim: int = 100, n_clusters: int = 100,
        n_samples: int = 700, patch_width: int = 10, stride: int = 2,
        pos_threshold: float = 0.9, hue: bool = False,
        hsv: bool = False, norm: str = "raw", seed: int = 0,
        gmm_init_idx=None, patch_init_idx=None, device=None
) -> PatchEmbedder:
    """End-to-end TrainHandler.py:2161-2291 on `device` (default cuda):
    fuse, fit pixel GMM + patch KMeans + tree probs (initial indices as
    `PatchEmbedder.fit`'s), pickle the embed tuple to out_path."""
    x, y = fuse_datasets(tree_x, tree_rewards, nav_x, nav_y,
                         n_samples, pos_threshold, seed)
    emb = PatchEmbedder(embed_dim=embed_dim, n_cluster=n_clusters,
                        channels=channels_for(hue, hsv),
                        pw=patch_width, stride=stride, norm=norm,
                        device=device)
    emb.fit(x, y, seed=seed, gmm_init_idx=gmm_init_idx,
            patch_init_idx=patch_init_idx)
    emb.save_embed_tuple(out_path)
    return emb
