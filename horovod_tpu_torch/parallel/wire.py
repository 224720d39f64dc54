"""The wire of the mesh's shuffle-shaped exchanges: the Ulysses flips, the
MoE all-to-alls and the pipeline hop.

Counterpart of ``horovod_tpu/xir/interp.py`` ``wire_request`` (``:211``)
and of the shuffle branch of ``horovod_tpu/xir/ir.py`` ``eligible_wire``
(``:210-237``).  A shuffle moves values that must arrive exactly where
they were sent, so the JAX package downgrades a wire request for it:
int8 and fp8 become ``off``, a non-floating payload stays dense, ``bf16``
on a payload that is already bf16 is ``off``; only ``bf16`` on a wider
floating payload casts (``interp.py`` ``_bf16_around``, B1 around the
exchange).  With ``HVD_TPU_XIR`` off the JAX package calls the dense
collective directly, whatever the wire.  The port runs every shuffle
dense; the one cast the JAX package makes is not ported (the exchange IR
is ROADMAP Queue A entry A12 (rest)) and raises.
"""

from __future__ import annotations

import torch

from ..utils import env

WIRES = ("off", "bf16", "int8", "fp8")


def xir_wire() -> str:
    """``HVD_TPU_XIR_WIRE`` as the JAX package reads it
    (``horovod_tpu/xir/interp.py`` ``wire_request``; default ``off``)."""
    raw = env.get_env("XIR_WIRE", "off") or "off"
    w = raw.strip().lower()
    if w in ("none", "0", "false", "no"):
        w = "off"
    if w == "e4m3":
        w = "fp8"
    if w not in WIRES:
        raise ValueError(f"HVD_TPU_XIR_WIRE must be one of {WIRES}, got {raw!r}")
    return w


def shuffle_wire(dtype: torch.dtype) -> str:
    """The wire a shuffle of a ``dtype`` payload takes: ``"bf16"`` where
    the JAX package casts, else ``"off"`` (``eligible_wire``'s shuffle
    branch, behind ``HVD_TPU_XIR``)."""
    if not env.get_bool("XIR", True):
        return "off"
    wire = xir_wire()
    if wire == "off" or not dtype.is_floating_point:
        return "off"
    if wire == "bf16" and dtype != torch.bfloat16:
        return "bf16"
    return "off"


def dense_shuffle(what: str, dtype: torch.dtype) -> None:
    """Raise unless the shuffle ``what`` of a ``dtype`` payload runs dense
    in the JAX package, as the port runs it."""
    if shuffle_wire(dtype) != "off":
        raise NotImplementedError(
            f"HVD_TPU_XIR_WIRE=bf16 on a {dtype} payload: the JAX package casts "
            f"{what} to bf16 through the exchange IR, which is not ported yet "
            "(ROADMAP Queue A entry A12 (rest)); unset it, or compute in bf16"
        )
