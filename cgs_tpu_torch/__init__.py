"""cgs_tpu_torch — PyTorch / CUDA port of `cgs_tpu` for an NVIDIA H100.

Critic-guided segmentation of rewarding objects in first-person views
(GCAI 2021, arXiv:2107.09540): a reward critic CNN and a U-Net masker.
This package is the port's first slice, the serving path: `-eval` and
`-process` through `Handler`, `MaskPipeline`, `Critic` and
`UnetDecoder`. The TPU kernels on that path are hand-written CUDA C++
kernels for Hopper in `csrc/`, built with `nvcc` at first use; each
wrapper runs its plain PyTorch version for a CPU tensor. Entry points
run on `cuda` unless the caller asks for the CPU.

It imports torch, numpy and the standard library only: never jax, nor
anything of the JAX package `cgs_tpu`, which stays the reference.
"""

__version__ = "0.1.0"

from cgs_tpu_torch.core.config import Config, build_arg_parser, parse_args  # noqa: F401
from cgs_tpu_torch.models.critic import Critic  # noqa: F401
from cgs_tpu_torch.models.decoder import UnetDecoder  # noqa: F401
from cgs_tpu_torch.pipeline import MaskPipeline  # noqa: F401
