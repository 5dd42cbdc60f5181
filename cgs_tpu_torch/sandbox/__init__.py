"""Research-sandbox capabilities (PyTorch port of `cgs_tpu/sandbox/`,
SURVEY.md §2.4): the multi-seed runner, the seed-parallel runner, the
paired ablation and the drift probe; TD(0) critic training, the frame
discriminator, gradient-ascent "dream", per-pixel HSV KMeans, the
mask-area experiment, the dev reward-discount exploration, the
patch-embedding GMM/KMeans family with its visualisers, the VGG
cosine-similarity strips, the U-Net embedding projection, the legacy
merge-training variants over the model zoo's U-Net, and the width sweep
(`bench_width`). The same exports as `cgs_tpu/sandbox/__init__.py`.
"""

from cgs_tpu_torch.sandbox.td_critic import make_td_critic_step, sarsa_pairs  # noqa: F401
from cgs_tpu_torch.sandbox.discriminator import make_discriminator_step  # noqa: F401
from cgs_tpu_torch.sandbox.dream import dream  # noqa: F401
from cgs_tpu_torch.sandbox.multirun import run_seeds  # noqa: F401
from cgs_tpu_torch.sandbox.cluster import cluster_frames, kmeans, rgb_to_hsv  # noqa: F401
from cgs_tpu_torch.sandbox.sum_segm import sum_segm_loss, train_sum_segm  # noqa: F401
from cgs_tpu_torch.sandbox.dev import dev, dev_discount_row, dev_label_matrix  # noqa: F401
from cgs_tpu_torch.sandbox.patch_embed import (  # noqa: F401
    PatchEmbedder, create_patch_embedding_clusters, gmm_fit)
from cgs_tpu_torch.sandbox.embed_viz import vis_embed, vis_pixels, vis_white_tree  # noqa: F401
from cgs_tpu_torch.sandbox.trans_embeds import trans_embeds  # noqa: F401
from cgs_tpu_torch.sandbox.unet_embeddings import vis_unet, vis_unet_embeddings  # noqa: F401
from cgs_tpu_torch.sandbox.merge_variants import (  # noqa: F401
    distnorm_loss, make_pair_merge_step, make_single_net_merge_step,
    percentile_split)
