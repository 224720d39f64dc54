"""The canonical data-parallel training steps: an image model's and a
language model's.

Counterpart of ``horovod_tpu/utils/benchmarks.py`` (``build_dp_step``
``:15``, ``timed_throughput`` ``:70``) and of the step of ``bench.py``
``bench_gpt`` (:func:`build_lm_step`, :func:`packed_lm_batch`).  A
torch module carries its weights, so the steps are built around an
existing model (the JAX functions initialise the flax model themselves)
and return the model and optimizer instead of parameter pytrees.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..compression import Compression
from ..optim.distributed_optimizer import CAPTURE_WARMUP


def _loss_fn(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y)


def build_dp_step(hvd, model: torch.nn.Module, *, compression=None,
                  lr: float = 0.01,
                  momentum: Optional[float] = 0.9, process_set=None,
                  op: Optional[int] = None, lowering: Optional[str] = None) -> Tuple:
    """Build the data-parallel step: rank 0's weights and buffers are
    broadcast (to the world), SGD (``lr``, ``momentum``; dampening 0, no
    Nesterov: the update of ``optax.sgd``) is wrapped in
    ``hvd.DistributedOptimizer`` (over ``process_set`` when given; ``op``
    Average unless given, e.g. ``hvd.Adasum``; ``lowering`` as
    ``HVD_TPU_TOPO_LOWER`` unless given), and the step minimises the
    mean softmax cross-entropy.

    Returns ``(step, optimizer)``; ``step(batch)`` runs one step on this
    rank's ``(images NHWC, labels)`` and returns the loss averaged across
    ranks."""
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum or 0.0),
        named_parameters=model.named_parameters(),
        compression=compression if compression is not None
        else hvd.Compression.none,
        process_set=process_set,
        op=hvd.Average if op is None else op,
        lowering=lowering,
    )
    return hvd.TrainStep(model, opt, _loss_fn), opt


def timed_throughput(step, batch, iters: int,
                     warmup: int = 3) -> Tuple[float, list]:
    """Run ``warmup`` + ``iters`` steps; return (seconds of the timed
    steps, every step's loss as a float).  A host read of the loss
    fences each phase: it waits for the step's device work."""
    losses = [float(step(batch)) for _ in range(warmup)]
    t0 = time.perf_counter()
    timed = [step(batch) for _ in range(iters)]
    if timed:
        float(timed[-1])
    seconds = time.perf_counter() - t0
    return seconds, losses + [float(t) for t in timed]


def window_labels(wire: Optional[str], overlap_pairs: int = 0,
                  onestep_pairs: int = 0) -> Tuple[str, ...]:
    """Labels of timing windows taken in turns: ``onestep_pairs`` pairs
    on ``wire`` (default bf16) with the step captured as one CUDA graph
    and run eagerly (``wire/captured``, ``wire/eager``, ``wire/eager``,
    ``wire/captured``, ...); else ``overlap_pairs`` pairs with each
    bucket's exchange launched from the backward and after it
    (``wire/overlapped``, ``wire/after``, ...); else bf16 against the
    plain wire (``bf16``, ``off``, ``off``, ``bf16``), framed by ``wire``
    when one is given."""
    pairs, modes = ((onestep_pairs, ("captured", "eager")) if onestep_pairs
                    else (overlap_pairs, ("overlapped", "after")))
    if pairs:
        return tuple(f"{wire or 'bf16'}/{m}" for _ in range(-(-pairs // 2))
                     for m in (modes[0], modes[1], modes[1], modes[0]))
    labels = ("bf16", "off", "off", "bf16")
    return (wire,) + labels + (wire,) if wire else labels


def select_window(label: str) -> None:
    """Set the knobs of a window label (:func:`window_labels`): the wire,
    ``HVD_TPU_SCHED_BARRIERS`` (off in the captured and eager windows, as
    by default, unless the label ends in ``+barriers``; else on unless
    ``after``) and ``HVD_TPU_ONESTEP`` (``on`` in the captured windows,
    else ``off``); they take effect from the next step."""
    wire, _, mode = label.partition("/")
    mode, _, extra = mode.partition("+")
    os.environ["HVD_TPU_SCHED_WIRE"] = wire
    os.environ["HVD_TPU_SCHED_BARRIERS"] = (
        "0" if mode in ("after", "captured", "eager") and extra != "barriers"
        else "1")
    os.environ["HVD_TPU_ONESTEP"] = "on" if mode == "captured" else "off"


def timed_window(step, batch, label: str, steps: int,
                 before=None) -> Tuple[float, float]:
    """One timing window of ``label``: its knobs set
    (:func:`select_window`), one warm-up step (a captured window's
    ``CAPTURE_WARMUP`` eager steps and its capture too), ``before()``
    when given, then ``steps`` timed steps fenced by a host read of the
    last loss.  Returns (seconds of the timed steps, the last loss)."""
    select_window(label)
    captured = label.partition("/")[2].startswith("captured")
    for _ in range(1 + (CAPTURE_WARMUP if captured else 0)):
        float(step(batch))  # a host read fences the previous work
    if before is not None:
        before()
    t0 = time.perf_counter()
    loss = None
    for _ in range(steps):
        loss = step(batch)
    last = float(loss)
    return time.perf_counter() - t0, last


def quartiles(values) -> list:
    """First quartile, median and third quartile (nearest rank)."""
    q = sorted(values)
    return [q[len(q) // 4], q[len(q) // 2], q[(3 * len(q)) // 4]]


def build_lm_step(hvd, model: torch.nn.Module, *, packed: bool,
                  compression=Compression.bf16, lr: float = 3e-4) -> Tuple:
    """Build the language-model step of ``bench.py`` ``bench_gpt``
    (``:149-257``): rank 0's weights are broadcast, AdamW with
    ``optax.adamw``'s defaults (betas 0.9 / 0.999, eps 1e-8, weight
    decay 1e-4 on every parameter) is wrapped in
    ``hvd.DistributedOptimizer`` with ``compression``, and the step
    minimises the next-token cross-entropy plus ``0.01 * aux``.

    Dense rows: ``step(tokens)`` with ``tokens [B, T]``; the target of
    position t is token t+1, and the last position's is the row's first
    token (``jnp.roll``).  Packed rows (``packed=True``):
    ``step((tokens, segment_ids))`` with the packed loss.  Returns
    ``(step, optimizer)``."""
    from ..models.transformer import (
        packed_token_cross_entropy,
        token_cross_entropy,
    )

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4,
                          capturable=next(model.parameters()).is_cuda),
        named_parameters=model.named_parameters(),
        compression=compression,
    )

    if packed:
        def loss_fn(m, batch):
            tokens, segs = batch
            logits, aux = m(tokens, segs)
            return packed_token_cross_entropy(logits, tokens, segs) + 0.01 * aux
    else:
        def loss_fn(m, tokens):
            logits, aux = m(tokens)
            target = torch.roll(tokens, -1, dims=-1)
            return token_cross_entropy(logits, target) + 0.01 * aux

    return hvd.TrainStep(model, opt, loss_fn), opt


def build_hybrid_lm_step(model: torch.nn.Module, mesh, *, packed: bool = False,
                         lr: float = 3e-4) -> Tuple:
    """Build the hybrid-parallel step of ``examples/gpt_pretrain.py``
    (``train_step``) for ``model`` (a ``Transformer`` made on ``mesh``):
    AdamW as ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)``
    (eps 1e-8, decay on every parameter; ``capturable=True`` when the
    weights are on a card), and a step that runs the forward on this
    rank's block of the batch, the backward, ``sync_gradients`` with the
    model's ``param_shard_axes``, the update, and returns the loss
    averaged over every mesh axis among dp, sp, tp and ep (``ep`` ranks
    hold different tokens, as ``dp`` ranks do).

    Dense rows: ``step(tokens, targets)`` (the next tokens); packed rows
    (``packed=True``): ``step(tokens, segment_ids)``.  The step runs
    eagerly: it is not a ``TrainStep``, and the mesh's collectives refuse
    to run under a CUDA graph's capture.  Returns ``(step, optimizer)``."""
    from ..models.transformer import (
        packed_token_cross_entropy,
        param_shard_axes,
        token_cross_entropy,
    )
    from ..parallel.grad_sync import pmean_, sync_gradients

    params = dict(model.named_parameters())
    shard_axes = param_shard_axes(params, model.cfg)
    on_card = next(model.parameters()).is_cuda
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, capturable=on_card)
    loss_axes = tuple(a for a in ("dp", "sp", "tp", "ep")
                      if mesh is not None and mesh.present(a))

    def step(tokens: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        model.train()
        if packed:
            logits, moe_aux = model(tokens, aux)
            loss = packed_token_cross_entropy(logits, tokens, aux)
        else:
            logits, moe_aux = model(tokens)
            loss = token_cross_entropy(logits, aux)
        loss = loss + 0.01 * moe_aux
        loss.backward()
        synced = sync_gradients({n: p.grad for n, p in params.items()}, shard_axes, mesh)
        for n, p in params.items():
            p.grad = synced[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            loss = loss.detach().reshape(1).clone()
            if loss_axes:
                loss = pmean_(loss, mesh, loss_axes)
        return loss[0]

    return step, opt


def packed_lm_batch(rows: int, seq_len: int = 1024, vocab_size: int = 50304,
                    seed: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """``bench_gpt``'s packed batch (``bench.py:174-186``): documents of
    ``clip(lognormal(5.8, 0.7), 32, seq_len)`` random tokens from
    ``RandomState(seed)``, drawn until they fill ``rows + 2`` rows, packed
    first-fit into ``seq_len`` and cut to ``rows``.  Returns int32
    ``(tokens, segment_ids)``."""
    from ..data.packing import pack_documents

    rng = np.random.RandomState(seed)
    docs, filled = [], 0
    while filled < rows + 2:
        n = int(np.clip(rng.lognormal(5.8, 0.7), 32, seq_len))
        docs.append(rng.randint(0, vocab_size, n).astype(np.int32))
        filled = sum(len(d) for d in docs) // seq_len
    tokens, segs = pack_documents(docs, seq_len)
    return tokens[:rows], segs[:rows]
