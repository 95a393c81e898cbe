"""Python-file configs with `_base_` inheritance.

The port's own copy of `panoswintransformerobjectdetection_tpu/runtime/config.py`
(`Config`, `load_config`, `merge_dict`, `set_by_dotted`), which reads the
repository's `configs/` the same way: a config is a Python file whose
module-level variables form a dict; `_base_` lists parent configs, merged
depth-first; `_delete_=True` in a dict replaces the inherited value instead
of merging; dotted overrides merge last.
"""

import copy
import importlib.util
import os.path as osp
import types
from typing import Any, Dict


class Config(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[k] = v
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def fromfile(path: str) -> "Config":
        return Config(load_config(path))


def _exec_config(path: str) -> Dict[str, Any]:
    spec = importlib.util.spec_from_file_location("_cfg_" + osp.basename(path), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)}


def merge_dict(base: Dict, new: Dict) -> Dict:
    """Recursive merge; `_delete_` in `new` replaces instead of merging."""
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict):
            v = dict(v)
            delete = v.pop("_delete_", False)
            if not delete and k in out and isinstance(out[k], dict):
                out[k] = merge_dict(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> Dict[str, Any]:
    cfg = _exec_config(path)
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = merge_dict(merged, load_config(osp.join(osp.dirname(path), b)))
    return merge_dict(merged, cfg)


def set_by_dotted(cfg: Dict, dotted: str, value):
    """`--cfg-options a.b.c=v` style override."""
    keys = dotted.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value
