"""Model-level building blocks and the flagship non-local denoiser
(PyTorch port of stnls_tpu/models), and RVRT with Shifted-NLS alignment
(the port's own: the upstream README's RVRT upgrade), and DiNAT, whose
dilated neighborhood attention runs on the port's search and pooled sum."""

from stnls_tpu_torch.models.blocks import (
    ResBlock, ResBlockList, ChannelAttention,
)
from stnls_tpu_torch.models.denoiser import NonLocalDenoiser
from stnls_tpu_torch.models.rvrt import RVRT
from stnls_tpu_torch.models.dinat import DiNAT
