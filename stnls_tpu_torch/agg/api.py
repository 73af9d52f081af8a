"""String-menu construction of aggregation ops (PyTorch port of
stnls_tpu/agg/api.py). The default "wpsum" resolves to PooledPatchSum, as
in the JAX package. Every entry resolves but "scatter" (NonLocalScatter)
and "stack_conv", which raise NotImplementedError."""

import importlib

from stnls_tpu_torch.utils.config import extract_pairs, ConfigDict

MENU = ConfigDict({
    "wpsum": "pool",
    "pool": "pool",
    "nlstack": "gather",
    "nlgather": "gather",
    "gather": "gather",
    "gather_add": "gather_add",
    "scatter": "scatter",
    "scatter_sum": "scatter_add",
    "scatter_add": "scatter_add",
    "stack_conv": "stack_conv",
})
PORTED = ("gather", "gather_add", "scatter_add", "pool")


def from_agg_menu(name):
    return MENU.get(name, name)


def _module(agg_name):
    pkg_name = from_agg_menu(agg_name)
    if pkg_name not in PORTED:
        raise NotImplementedError(
            f"agg {agg_name!r} ({pkg_name}) is not yet ported, see ROADMAP")
    return importlib.import_module(f"stnls_tpu_torch.agg.{pkg_name}")


def extract_config(_cfg, restrict=True):
    pairs = {"agg_name": "wpsum"}
    agg_name = extract_pairs(_cfg, pairs, restrict=False)["agg_name"]
    cfg = _module(agg_name).extract_config(_cfg)
    cfg.agg_name = agg_name
    return cfg


def init(cfg):
    cfg = extract_config(cfg)
    return _module(cfg.agg_name).init(cfg)
