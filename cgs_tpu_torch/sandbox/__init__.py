"""Research-sandbox capabilities (PyTorch port of `cgs_tpu/sandbox/`,
SURVEY.md §2.4): the multi-seed runner, the seed-parallel runner, the
paired ablation and the drift probe; TD(0) critic training, the frame
discriminator, gradient-ascent "dream", the mask-area experiment, the
VGG cosine-similarity strips, the U-Net embedding projection and the
legacy merge-training variants over the model zoo's U-Net. The same
exports as `cgs_tpu/sandbox/__init__.py` for what is ported.
"""

from cgs_tpu_torch.sandbox.td_critic import make_td_critic_step, sarsa_pairs  # noqa: F401
from cgs_tpu_torch.sandbox.discriminator import make_discriminator_step  # noqa: F401
from cgs_tpu_torch.sandbox.dream import dream  # noqa: F401
from cgs_tpu_torch.sandbox.multirun import run_seeds  # noqa: F401
from cgs_tpu_torch.sandbox.sum_segm import sum_segm_loss, train_sum_segm  # noqa: F401
from cgs_tpu_torch.sandbox.trans_embeds import trans_embeds  # noqa: F401
from cgs_tpu_torch.sandbox.unet_embeddings import vis_unet, vis_unet_embeddings  # noqa: F401
from cgs_tpu_torch.sandbox.merge_variants import (  # noqa: F401
    distnorm_loss, make_pair_merge_step, make_single_net_merge_step,
    percentile_split)
