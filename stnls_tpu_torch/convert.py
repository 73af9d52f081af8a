"""Carry flax parameters over to the PyTorch modules.

`params_from_jax(params)` takes the parameter tree of the JAX package's
flax `NonLocalAttention` as nested dicts of numpy arrays (it imports no
JAX) and returns a `state_dict` for stnls_tpu_torch.nn.NonLocalAttention:

  * a flax Conv kernel [kh,kw,Cin,Cout] becomes a torch Conv2d weight
    [Cout,Cin,kh,kw]; biases are copied;
  * a flax LayerNorm's scale/bias become the torch LayerNorm weight/bias;
  * plain weights outside any flax module (the bench step's proj_w [F,F]
    and stack_w [K,F,F]) pass through unchanged, since the port keeps the
    same einsum layouts.
"""

import numpy as np
import torch

# flax module path -> torch module path
_MODULES = {
    ("qkv", "to_q"): "qkv.to_q",
    ("qkv", "to_k"): "qkv.to_k",
    ("qkv", "to_v"): "qkv.to_v",
    ("proj",): "proj",
    ("norm_layer", "LayerNorm_0"): "norm_layer.norm",
}


def _leaves(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


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
        if mod not in _MODULES:
            raise KeyError(f"no torch counterpart for flax module {mod}")
        name = _MODULES[mod]
        if leaf == "kernel":              # [kh,kw,Cin,Cout] -> [Cout,Cin,kh,kw]
            state[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf == "scale":
            state[f"{name}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "bias":
            state[f"{name}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unknown flax leaf {path}")
    return state
