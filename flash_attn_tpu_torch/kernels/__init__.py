"""The port's kernels: one module per kernel family, each with its CUDA
wrapper, its plain PyTorch version and module-level integers ``launches*``
that the wrapper advances where it launches its kernel.

:func:`launch_counters` is the one registry of those counters: it finds
them in every module of this package, so a new kernel module is counted
without being listed anywhere."""

import importlib
import pkgutil
from typing import Dict, Tuple

__all__ = ["launch_counters", "reset_launch_counters"]


def launch_counters() -> Dict[Tuple[object, str], int]:
    """Every kernel wrapper's launch counter, as (module, name) -> count."""
    out = {}
    for info in pkgutil.iter_modules(__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{__name__}.{info.name}")
        for attr, val in vars(mod).items():
            if attr.startswith("launches") and isinstance(val, int):
                out[(mod, attr)] = val
    return out


def reset_launch_counters() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    for mod, attr in launch_counters():
        setattr(mod, attr, 0)
