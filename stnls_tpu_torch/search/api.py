"""String-menu construction of search ops (PyTorch port of
stnls_tpu/search/api.py). Only the ported entries resolve; the others
raise NotImplementedError."""

import importlib

from stnls_tpu_torch.utils.config import extract_pairs, ConfigDict

MENU = ConfigDict({
    "exact": "non_local_search",
    "nls": "non_local_search",
    "nl": "non_local_search",
    "refine": "refinement",
    "pair": "paired_search",
    "paired": "paired_search",
    "paired_refine": "paired_refine",
    "paired_ref": "paired_refine",
    "rand_inds": "rand_inds",
    "n3mm": "n3mm_search",
})
PORTED = ("non_local_search",)


def from_search_menu(name):
    return MENU.get(name, name)


def _module(search_name):
    pkg_name = from_search_menu(search_name)
    if pkg_name not in PORTED:
        raise NotImplementedError(
            f"search {search_name!r} ({pkg_name}) is not yet ported, "
            "see ROADMAP")
    return importlib.import_module(f"stnls_tpu_torch.search.{pkg_name}")


def extract_config(_cfg, restrict=True):
    pairs = {"search_name": "nls"}
    search_name = extract_pairs(_cfg, pairs, restrict=False)["search_name"]
    cfg = _module(search_name).extract_config(_cfg)
    cfg.search_name = search_name
    return cfg


def init(cfg):
    cfg = extract_config(cfg, False)
    return _module(cfg.search_name).init(cfg)
