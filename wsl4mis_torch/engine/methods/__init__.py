"""Training methods of the port. ``get_method(name)`` returns the module;
each exposes ``build(cfg) -> MethodBundle`` and ``make_step(cfg)``.

This slice has fully_supervised, pce and dmpls; the other methods of the
JAX package raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from importlib import import_module

_METHODS = {
    "fully_supervised": "fully_supervised",
    "pce": "pce",
    "dmpls": "dmpls",
}

# method -> ROADMAP.md Queue 1 item that ports it
_NOT_YET = {
    "pce_tv": 10, "pce_entropy_mini": 10, "pce_gatedcrf": 10,
    "pce_mumford_shah": 10, "pce_intensity_variance": 10,
    "pce_random_walker": 15,
    "mean_teacher": 11, "uamt": 11, "entropy_minimization": 11,
    "partially_supervised": 11, "deep_adversarial": 11,
    "s2l": 12, "ustm": 12, "scribblevc": 13,
}


def get_method(name: str):
    if name in _NOT_YET:
        raise NotImplementedError(
            f"method {name!r} is not ported yet (ROADMAP.md Queue 1, item "
            f"{_NOT_YET[name]})")
    try:
        mod_name = _METHODS[name]
    except KeyError:
        raise KeyError(f"unknown method {name!r}; available: "
                       f"{sorted(_METHODS)}") from None
    return import_module(f".{mod_name}", __package__)


def available_methods():
    return sorted(_METHODS)
