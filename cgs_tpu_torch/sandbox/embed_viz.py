"""Patch-embedding result visualizations (PyTorch port of
`cgs_tpu/sandbox/embed_viz.py`; reference `vis_embed`
TrainHandler.py:2293-2382, `vis_white_tree` :2722-2811, `vis_pixels`
:2813-2851).

Host-side artifact writers driven by
:mod:`cgs_tpu_torch.sandbox.patch_embed` (its embedding and fits run on
the embedder's device). All frame inputs are HSV floats in [0, 1]
shaped (B, 64, 64, 3), matching the reference's color pipeline. HSV is
turned into RGB by `utils/colors.hsv_to_rgb` (numpy, matplotlib's
arithmetic); only `vis_pixels`, a matplotlib figure, needs matplotlib,
and it raises an ImportError naming it where it is absent.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from cgs_tpu_torch.sandbox.patch_embed import PatchEmbedder
from cgs_tpu_torch.sandbox.unet_embeddings import resize_bilinear
from cgs_tpu_torch.utils.colors import hsv_to_rgb
from cgs_tpu_torch.utils.video import vidwrite


def vis_embed(embedder: PatchEmbedder, frames_hsv: np.ndarray,
              out_dir: str, result_args: str = "embed",
              threshold: float = 0.4, batchsize: int = 512,
              max_frames: int = 1024) -> str:
    """TrainHandler.py:2293-2382: per-frame 4-panel strips
    [rgb | prob-masked rgb | hard mask | resized probs] written as one
    video `{result_args}.mp4` (the reference writes XVID .avi; this
    writes MP4 via utils.video). Returns the video path."""
    os.makedirs(out_dir, exist_ok=True)
    x = frames_hsv[:max_frames]
    thresh = embedder.convert_treshold(threshold)

    problist = []
    for bidx in range(0, len(x), batchsize):
        probs, _ = embedder.predict_batch(x[bidx:bidx + batchsize])
        problist.append(probs)
    probs = np.concatenate(problist, axis=0)

    rgb = hsv_to_rgb(x)
    strips = []
    for idx, frame in enumerate(probs):
        resized = np.ones((64, 64, 3)) * resize_bilinear(
            frame, (64, 64))[:, :, None]
        clean_mask = resized > thresh
        masked_rgb = rgb[idx] * clean_mask
        pic = np.concatenate(
            (rgb[idx], masked_rgb, clean_mask, resized), axis=1)
        strips.append((255 * np.clip(pic, 0, 1)).astype(np.uint8))
    path = os.path.join(out_dir, result_args + ".mp4")
    vidwrite(path, np.stack(strips), framerate=20)
    return path


def vis_white_tree(embedder: PatchEmbedder, frames_hsv: np.ndarray,
                   out_dir: str, result_args: str = "white-tree",
                   ref_index: int | None = None,
                   crop: Tuple[float, float, float, float] = (
                       0.3, 0.7, 0.75, 1.0),
                   top: int = 3) -> dict:
    """TrainHandler.py:2722-2811: pick a reference "white tree" frame,
    find the `top` patch-cluster labels inside its crop window, save
    their top pixel-color swatches, and render 5-panel strips
    [rgb | prob-weighted | probs | hard mask | label map w/ the
    selected labels highlighted] as video + per-frame PNGs.

    ref_index defaults to the last frame (the reference hardcodes
    index 324 of its 330-frame slice, :2765). The label histogram runs
    over range(embed_dim) — the reference's own indexing
    (:2772, a quirk: labels are patch-cluster ids; embed_dim ==
    n_cluster in every reference config) — preserved when the two
    sizes agree, else range(n_cluster)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    frame_dir = os.path.join(out_dir, result_args)
    os.makedirs(frame_dir, exist_ok=True)
    x = frames_hsv
    ref_index = len(x) - 1 if ref_index is None else ref_index

    probs, labels = embedder.predict_batch(x)

    y1, y2, x1, x2 = crop
    # the reference frame's label map is row ref_index of the
    # full-batch result
    ph, pw = labels.shape[1:3]
    wtcrop = labels[ref_index, int(ph * y1):int(ph * y2),
                    int(pw * x1):int(pw * x2)].reshape(-1)
    n_bins = (embedder.embed_dim
              if embedder.embed_dim == embedder.n_cluster
              else embedder.n_cluster)
    counts = [np.sum(wtcrop == i) for i in range(n_bins)]
    wtlabelset = np.argsort(counts)[::-1][:top]

    swatch_paths = []
    for idx, label in enumerate(wtlabelset):
        sw = embedder.patch_label_to_color(int(label))
        p = os.path.join(out_dir, f"top_pixel_colors_{idx}.png")
        Image.fromarray(sw).save(p)
        swatch_paths.append(p)

    rgb = hsv_to_rgb(x)
    strips = []
    for idx, frame in enumerate(probs):
        resized = np.ones((64, 64, 3)) * resize_bilinear(
            frame, (64, 64))[:, :, None]
        clean_mask = resized > 0.7
        masked_rgb = rgb[idx] * resized
        frame_labels = resize_bilinear(labels[idx].astype(np.float32),
                                       (64, 64))
        # the reference's clean() mutates frame_labels IN PLACE and
        # tests raw bilinear floats for set membership
        # (TrainHandler.py:2798-2804), so BOTH the value and hue
        # channels render the cleaned map — reproduced, aliasing
        # included
        cleaned = np.where(np.isin(frame_labels, wtlabelset),
                           frame_labels, 0)
        labeled = np.ones((64, 64, 3))
        labeled[:, :, 2] = cleaned / embedder.n_cluster
        labeled[:, :, 0] = cleaned / embedder.n_cluster
        labeled = hsv_to_rgb(np.clip(labeled, 0, 1))
        pic = np.concatenate((rgb[idx], masked_rgb, resized,
                              clean_mask, labeled), axis=1)
        u8 = (255 * np.clip(pic, 0, 1)).astype(np.uint8)
        strips.append(u8)
        Image.fromarray(u8).save(os.path.join(frame_dir, f"{idx}.png"))
    video = os.path.join(out_dir, result_args + ".mp4")
    vidwrite(video, np.stack(strips), framerate=20)
    return {"video": video, "labelset": np.asarray(wtlabelset),
            "swatches": swatch_paths}


def vis_pixels(frames_u8: np.ndarray, out_png: str,
               n_components: int = 100, subsample: int = 200,
               seed: int = 0, init_idx=None, device=None) -> str:
    """TrainHandler.py:2813-2851: 3-panel pixel-space figure —
    log-scaled 2-D histogram of (channel0, channel1) pixel values, the
    HS color wheel, and a GMM clustering scatter of sub-sampled
    pixels. The reference plt.show()s; this saves to out_png
    (headless). The GMM is `patch_embed.gmm_fit` on `device` (default
    cuda; its KMeans's initial indices `init_idx`, else drawn from
    `seed`). Needs matplotlib: where it is absent this raises an
    ImportError that says so (there is no other plot of it)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import colors
    except ImportError as e:
        raise ImportError("vis_pixels draws a matplotlib figure and "
                          f"matplotlib is not installed: {e}") from e

    from cgs_tpu_torch.sandbox.patch_embed import gmm_assign, gmm_fit

    pixels = frames_u8.reshape(-1, 3)

    my_cmap = matplotlib.colormaps["plasma"].copy()
    my_cmap.set_bad(my_cmap(0.0))
    hs_pic = np.array([[[h, s, 1] for s in range(255)]
                       for h in range(255)], np.float32)
    hs_pic = 255 * hsv_to_rgb(hs_pic / 255)

    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, sharey=True,
                                        figsize=(12, 4))
    for ax in (ax1, ax2, ax3):
        ax.set_aspect(1)
    # float array stays float: v=1 pre-/255 makes hsv value 1/255, so
    # 255*hsv_to_rgb lands back in [0,1] — imshow renders float RGB on
    # the 0-1 scale (a full-bright wheel, TrainHandler.py:2826-2833)
    ax2.imshow(hs_pic)
    ax2.invert_yaxis()
    ax1.hist2d(pixels[:, 0], pixels[:, 1], bins=100,
               norm=colors.LogNorm(), cmap=my_cmap)

    sub = pixels[::subsample, :2].astype(np.float32)
    params = gmm_fit(sub, n_components, seed=seed, init_idx=init_idx,
                     device=device)
    labels = gmm_assign(params, sub, device=device).cpu().numpy()
    ax3.scatter(sub[:, 0], sub[:, 1], c=labels, s=0.5, cmap="jet")
    ax3.set_xlim(0, 255)
    ax3.set_ylim(0, 255)
    plt.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
