"""The whole-step knob, ``HVD_TPU_ONESTEP``.

Counterpart of the onestep knob of ``horovod_tpu/xir/interp.py``
(``:55-124``): the same modes, spellings, errors, override and default
(``auto``).  The JAX package folds a step's dispatch units (its bucket
chain and the optimizer update) into one compiled program; the port
captures its data-parallel step as one CUDA graph
(``optim/distributed_optimizer.py`` ``TrainStep``), where the units are
the schedule's buckets and the update: ``onestep_engaged(len(schedule)
+ 1)``.
"""

from __future__ import annotations

from typing import Optional

from ..exceptions import HorovodTpuError
from ..utils import env

ONESTEP_MODES = ("off", "on", "auto")

_onestep_override: Optional[str] = None


def set_onestep_override(mode: Optional[str]) -> None:
    """Pin the mode without touching the environment (None: read it)."""
    global _onestep_override
    if mode is not None and mode not in ONESTEP_MODES:
        raise HorovodTpuError(
            f"onestep mode override must be one of {ONESTEP_MODES}, "
            f"got {mode!r}"
        )
    _onestep_override = mode


def onestep_mode() -> str:
    """``HVD_TPU_ONESTEP``: ``off`` | ``on`` | ``auto`` (default).
    ``off`` runs every step eagerly; ``auto`` captures a step of at least
    two dispatch units; ``on`` always captures, and raises where a step
    cannot be captured."""
    if _onestep_override is not None:
        return _onestep_override
    raw = (env.get_env(env.ONESTEP, "auto") or "auto").strip().lower()
    if raw in ("0", "false", "no", "none", ""):
        raw = "off"
    if raw in ("1", "true", "yes"):
        raw = "on"
    if raw not in ONESTEP_MODES:
        raise HorovodTpuError(
            f"HVD_TPU_ONESTEP must be off|on|auto, got {raw!r}"
        )
    return raw


def onestep_engaged(n_units: int) -> bool:
    """Whether a step of ``n_units`` dispatch units is folded: ``off``
    never, ``on`` always, ``auto`` from two units up (one unit gains
    nothing from the fold)."""
    m = onestep_mode()
    if m == "off":
        return False
    if m == "on":
        return n_units >= 1
    return n_units >= 2
