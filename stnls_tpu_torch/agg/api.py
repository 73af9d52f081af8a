"""String-menu construction of aggregation ops (PyTorch port of
stnls_tpu/agg/api.py). The default "wpsum" resolves to PooledPatchSum, as
in the JAX package."""

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


def from_agg_menu(name):
    return MENU.get(name, name)


def _module(agg_name):
    return importlib.import_module(
        f"stnls_tpu_torch.agg.{from_agg_menu(agg_name)}")


def extract_config(_cfg, restrict=True):
    pairs = {"agg_name": "wpsum"}
    agg_name = extract_pairs(_cfg, pairs, restrict=False)["agg_name"]
    cfg = _module(agg_name).extract_config(_cfg)
    cfg.agg_name = agg_name
    return cfg


def init(cfg):
    cfg = extract_config(cfg)
    return _module(cfg.agg_name).init(cfg)
