"""Menu access to normalisation methods (PyTorch port of
stnls_tpu/normz/api.py)."""

from stnls_tpu_torch.utils import config
from stnls_tpu_torch.normz import softmax


def default_pairs():
    return {"normz_scale": 10,
            "normz_name": "softmax",
            "normz_drop_rate": 0.,
            "dist_type": "l2",
            "k_agg": -1}


def extract_config(cfg, restrict=True):
    return config.extract_pairs(cfg, default_pairs(), restrict=restrict)


def init_normz(cfg):
    cfg = extract_config(cfg, False)
    modules = {"softmax": softmax}
    return modules[cfg.normz_name].init(cfg)


def init(cfg):
    return init_normz(cfg)
