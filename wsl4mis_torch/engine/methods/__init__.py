"""Training methods of the port. ``get_method(name)`` returns the module;
each exposes ``build(cfg) -> MethodBundle`` and ``make_step(cfg)``.

Ported so far: fully_supervised, pce, dmpls, the five pCE + regularizer
methods of ``pce_regularized``, pce_random_walker (fully_supervised's step
on sup_type="random_walker"), the semi-supervised mean_teacher, uamt,
entropy_minimization and partially_supervised of ``mean_teacher``,
deep_adversarial, ustm and s2l; scribblevc raises NotImplementedError
naming its ROADMAP item.
"""

from __future__ import annotations

from importlib import import_module

_METHODS = {
    "fully_supervised": "fully_supervised",
    "pce": "pce",
    "dmpls": "dmpls",
    "pce_tv": "pce_regularized",
    "pce_entropy_mini": "pce_regularized",
    "pce_gatedcrf": "pce_regularized",
    "pce_mumford_shah": "pce_regularized",
    "pce_intensity_variance": "pce_regularized",
    "pce_random_walker": "fully_supervised",
    "mean_teacher": "mean_teacher",
    "uamt": "mean_teacher",
    "entropy_minimization": "mean_teacher",
    "partially_supervised": "mean_teacher",
    "deep_adversarial": "deep_adversarial",
    "ustm": "ustm",
    "s2l": "s2l",
}

# method -> ROADMAP.md Queue 1 item that ports it
_NOT_YET = {"scribblevc": 13}


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
