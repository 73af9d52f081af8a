"""Model-level building blocks and the flagship non-local denoiser
(PyTorch port of stnls_tpu/models)."""

from stnls_tpu_torch.models.blocks import (
    ResBlock, ResBlockList, ChannelAttention,
)
from stnls_tpu_torch.models.denoiser import NonLocalDenoiser
