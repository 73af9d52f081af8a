"""StackConv: the NonLocalGather stack followed by the Conv3d projection
menu (PyTorch port of stnls_tpu/agg/stack_conv.py).

On CUDA tensors the stack comes from the gather kernel B3 (its backward
B4); the projection is a torch Conv3d.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.agg.gather import (
    extract_config as extract_config_stack, init as init_stack)
from stnls_tpu_torch.agg.proj_menu import (
    extract_config as extract_config_proj, init as init_proj)


class StackConv(torch.nn.Module):
    """vid, weights, flows -> stack [B,HD,K,T,C,H,W] -> [(B T), (HD C), K,
    H, W] -> proj -> [B,T,C',H,W]."""

    def __init__(self, stacker, proj, proj_version="v1"):
        super().__init__()
        self.stacker = stacker
        self.proj = proj
        self.proj_version = proj_version

    def forward(self, vid, weights, flows, deterministic=True):
        stack = self.stacker(vid, weights, flows)
        B, HD, K, T, C, H, W = stack.shape
        stack = stack.permute(0, 3, 1, 4, 2, 5, 6).reshape(B * T, HD * C, K,
                                                           H, W)
        out = self.proj(stack, deterministic=deterministic)
        return out.reshape(B, T, -1, H, W)


def extract_config(_cfg, restrict=True):
    stack_cfg = extract_config_stack(_cfg, restrict=restrict)
    proj_cfg = extract_config_proj(_cfg, restrict=restrict)
    pairs = dict(stack_cfg)
    pairs.update(proj_cfg)
    return extract_pairs(_cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg, False)
    return StackConv(stacker=init_stack(cfg), proj=init_proj(cfg),
                     proj_version=cfg.nlstack_proj_version)
