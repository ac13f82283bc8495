"""``DockConfig`` and ``PRESETS``, shared with the JAX package.

The dataclass is defined once, in ``deeplocalproteindocking_tpu/config.py``,
so a checkpoint's ``config.json`` is read one way by both packages.  That
file imports only the standard library, but importing it as a module of
its package would run ``deeplocalproteindocking_tpu/__init__.py``, which
may import jax.  So this module executes that one file on its own, under
a name of this package, and re-exports what it defines.
"""
from __future__ import annotations

import importlib.util
import os
import sys

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "deeplocalproteindocking_tpu", "config.py")


def _load_shared_config():
    name = "deeplocalproteindocking_torch._shared_config"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _SOURCE)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module        # dataclasses resolve __module__
    spec.loader.exec_module(module)
    return module


_shared = _load_shared_config()
DockConfig = _shared.DockConfig
PRESETS = _shared.PRESETS

__all__ = ["DockConfig", "PRESETS"]
