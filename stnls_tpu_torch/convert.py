"""Carry flax parameters over to the PyTorch modules.

`params_from_jax(params)` takes the parameter tree of one of the JAX
package's flax modules as nested dicts of numpy arrays (it imports no
JAX) and returns a `state_dict` for its counterpart in stnls_tpu_torch:
NonLocalAttention (any aggregator, stack_conv included),
NonLocalAttentionStack, NonLocalDenoiser, and ResBlock, ResBlockList and
ChannelAttention of stnls_tpu_torch.models. Each flax module path is
mapped by `_MODULES` to a torch module path and a layer kind; an unknown
path raises KeyError.

  * a Conv2d: the flax kernel [kh,kw,Cin,Cout] becomes the weight
    [Cout,Cin,kh,kw];
  * a Conv3d (StackConv's projection, agg/proj/Conv_0): [kd,kh,kw,Cin,
    Cout] becomes [Cout,Cin,kd,kh,kw];
  * a Linear (ChannelAttention's Dense_0, Dense_1): [in,out] becomes
    [out,in];
  * a LayerNorm's scale/bias become the torch LayerNorm's weight/bias;
  * biases are copied;
  * plain weights outside any flax module (the bench step's proj_w [F,F]
    and stack_w [K,F,F]) pass through unchanged, since the port keeps the
    same einsum layouts.
"""

import re

import numpy as np
import torch

# the attention's own modules, at the top or under a denoiser's "attn/"
_ATTN = r"(?P<pre>attn/)?(?P<mod>{})"
# (flax module path pattern, torch module path, layer kind); the torch path
# is a template of the match's groups
_MODULES = (
    (_ATTN.format(r"qkv/to_[qkv]|proj|stack_proj"), "{pre}{mod}", "conv2d"),
    (_ATTN.format(r"norm_layer/LayerNorm_0"), "{pre}norm_layer/norm",
     "norm"),
    (_ATTN.format(r"agg/proj/Conv_0"), "{pre}agg/proj/conv", "conv3d"),
    # the denoiser's convs; ResBlockList's and ResBlock's own paths
    (r"(?P<mod>embed|out|(res/)?(block\d+/)?conv[01])", "{mod}", "conv2d"),
    # ChannelAttention's, under a denoiser's "chnl/" or alone
    (r"(?P<pre>chnl/)?Dense_(?P<i>[01])", "{pre}dense{i}", "linear"),
)
# the rank of each layer kind's flax kernel, and its move to torch's layout
_KERNELS = {"conv2d": (4, (3, 2, 0, 1)), "conv3d": (5, (4, 3, 0, 1, 2)),
            "linear": (2, (1, 0))}


def _leaves(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def _torch_module(mod):
    """flax module path (a tuple) -> (torch module path, layer kind)."""
    flat = "/".join(mod)
    for pattern, name, kind in _MODULES:
        m = re.fullmatch(pattern, flat)
        if m:
            groups = {k: v or "" for k, v in m.groupdict().items()}
            return name.format(**groups).replace("/", "."), kind
    raise KeyError(f"no torch counterpart for flax module {mod}")


def params_from_jax(params):
    """flax params (numpy arrays, optionally under a top-level "params"
    key) -> state_dict of torch tensors."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, val in _leaves(params):
        arr = np.asarray(val, dtype=np.float32)
        mod, leaf = path[:-1], path[-1]
        if not mod:                       # plain weight: passes through
            state[leaf] = torch.from_numpy(arr.copy())
            continue
        name, kind = _torch_module(mod)
        if leaf == "kernel" and kind in _KERNELS:
            rank, axes = _KERNELS[kind]
            if arr.ndim != rank:
                raise KeyError(f"flax {kind} kernel {path} has rank "
                               f"{arr.ndim}, not {rank}")
            state[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(axes)))
        elif leaf == "scale" and kind == "norm":
            state[f"{name}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "bias":
            state[f"{name}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unknown flax leaf {path}")
    return state
