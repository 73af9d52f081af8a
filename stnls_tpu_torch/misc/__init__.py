"""Misc application modules (PyTorch port of stnls_tpu/misc): the model
building blocks, video non-local Bayes denoising and flow-patch scores."""

from stnls_tpu_torch.models.blocks import (
    ResBlock, ResBlockList, ChannelAttention,
)
from stnls_tpu_torch.misc import vnlb
from stnls_tpu_torch.misc import flow_patches
