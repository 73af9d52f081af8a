"""Config-dict plumbing (copied from stnls_tpu/utils/config.py; framework-free).

`extract_pairs(cfg, pairs, restrict=True)` pulls the keys named in `pairs`
out of `cfg`, falling back to the defaults; with restrict=False any extra
keys in cfg are preserved. Returns an attribute-accessible dict.
"""


class ConfigDict(dict):
    """Tiny EasyDict replacement: attribute access over a plain dict."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def optional(cfg, key, default):
    """Read `key` from a dict-like cfg with a default (reference utils.misc)."""
    if cfg is None:
        return default
    if hasattr(cfg, "get"):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


def optional_delete(cfg, key):
    if cfg is None:
        return
    if key in cfg:
        del cfg[key]


def extract_pairs(cfg, pairs, restrict=True):
    out = ConfigDict()
    cfg = {} if cfg is None else cfg
    for key, default in pairs.items():
        out[key] = optional(cfg, key, default)
    if not restrict:
        for key in cfg:
            if key not in out:
                out[key] = cfg[key]
    return out
