"""A configuration's parameters as the benchmark's own code reads them.

``configs/<name>.json`` holds, under ``params``, every setting of the port's
``Config`` that the cell runs with, nested as that dataclass nests them.
``namespace`` turns them into attribute access (``cfg.map.bound``) for the
generator, the references and the counts, which import nothing of the
program: a setting they read that the file lacks is an AttributeError, not
a silent default. ``port_config`` builds the port's ``Config`` from the same
values and checks that each one landed.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace


def namespace(params: dict) -> SimpleNamespace:
    """Nested dicts -> nested namespaces; lists become tuples."""
    out = SimpleNamespace()
    for key, val in params.items():
        if isinstance(val, dict):
            val = namespace(val)
        elif isinstance(val, list):
            val = tuple(val)
        setattr(out, key, val)
    if hasattr(out, "map") and hasattr(out.map, "occ_map_size"):
        # the port's Config properties (config.py: grid_shift, grid_scale)
        out.grid_shift = out.map.occ_map_size / 2.0
        out.grid_scale = out.map.bound / out.grid_shift
    return out


def _replace(obj, params: dict, where: str):
    changes = {}
    names = {f.name for f in dataclasses.fields(obj)}
    for key, val in params.items():
        if key not in names:
            raise KeyError(f"{where}{key}: no such setting of the port's Config")
        cur = getattr(obj, key)
        if isinstance(val, dict):
            changes[key] = _replace(cur, val, f"{where}{key}.")
        else:
            changes[key] = tuple(val) if isinstance(val, list) else val
    return dataclasses.replace(obj, **changes)


def port_config(params: dict):
    """The port's ``Config`` with every value of ``params`` set."""
    from live_ekf_slam_tpu_torch.config import Config

    cfg = _replace(Config(), params, "")
    _check(cfg, params, "")
    return cfg


def _check(obj, params: dict, where: str):
    for key, val in params.items():
        cur = getattr(obj, key)
        if isinstance(val, dict):
            _check(cur, val, f"{where}{key}.")
        elif (tuple(val) if isinstance(val, list) else val) != cur:
            raise ValueError(f"{where}{key}: set {val!r}, the Config holds {cur!r}")
