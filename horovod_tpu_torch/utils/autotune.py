"""Online autotuning of the fusion threshold, the hierarchical allreduce
and the quantized wire.

Counterpart of ``horovod_tpu/utils/autotune.py``: ``FusionAutotuner``
(the suggest/observe loop over log2 of the threshold, its GP/EI search in
the native core, ``native.Autotune``, with a grid sweep where the core
is not built) and ``AutotuneDriver`` (threshold, then hierarchical, then
quantized, then one joint-refinement round; the ``HVD_TPU_AUTOTUNE_*``
sub-knobs).  Reference: ``ParameterManager``
(``horovod/common/parameter_manager.{h,cc}``) scores each tuning window
by observed throughput and freezes the best value.

Under ``HVD_TPU_AUTOTUNE=1`` ``TrainStep`` (``optim/distributed_optimizer.py``)
drives the driver by itself: each (threshold, hierarchical, quantized)
variant is its own captured CUDA graph on a card, as each is its own
compiled program in the JAX package.

Two things differ from the JAX package.  The window fence is a
``torch.cuda.synchronize`` of the step's device (a host read of the loss
on the CPU); the JAX package's stall watchdog around it has no port yet.
And a window's timed region starts after the last step that was not
*settled* (``after_step(out, settled=False)``): the JAX package fences
out the first step of every window, which pays the compile of a new
variant; on a card a new variant's first calls are ``CAPTURE_WARMUP``
eager steps and the capture, so ``TrainStep`` reports each of them
unsettled and the window restarts its clock after each, and times only
replays.  A settled step (a replay, or any eager step) keeps the JAX
rule, so on the CPU both packages time the same steps.

In a world of several ranks each rank runs its own driver (the JAX
package has one controller for the whole world), and the ranks must
not decide apart: two ranks that froze different thresholds, lowerings
or wires would issue collectives of different sizes and formats, which
hangs or corrupts the sum.  So rank 0 decides.  Every call while the
driver explores agrees on whether the step was settled (a MIN
all-reduce of one flag: a fault plan can block the capture on one rank
only), so every rank opens and closes the same windows, and each closed
window's score is rank 0's (a broadcast) before it reaches the knob
schedule, which is deterministic, the native GP/EI search included.
Both go over host tensors (``runtime.host_group``: gloo beside NCCL),
so the flag does not wait for the card's step; a converged driver
issues nothing.
"""

from __future__ import annotations

import math
from typing import Optional

from . import env
from .logging import get_logger


def _world() -> bool:
    """Whether the runtime is a world of several ranks."""
    from .. import runtime

    return runtime.is_initialized() and runtime.size() > 1


def world_settled(settled: bool) -> bool:
    """Whether the call was settled on every rank (module docstring)."""
    if not _world():
        return settled
    import torch
    import torch.distributed as dist

    from .. import runtime

    flag = torch.tensor([int(settled)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=runtime.host_group())
    return bool(flag.item())


def world_score(score: float) -> float:
    """Rank 0's ``score`` on every rank (module docstring)."""
    if not _world():
        return score
    import torch
    import torch.distributed as dist

    from .. import runtime

    value = torch.tensor([score], dtype=torch.float64)
    dist.broadcast(value, src=0, group=runtime.host_group())
    return float(value.item())


class FusionAutotuner:
    """Suggest/observe loop for the fusion threshold knob.

    Usage::

        tuner = FusionAutotuner()
        while training:
            thr = tuner.threshold_bytes()
            step = build_step(fusion_threshold_bytes=thr)   # recompiles
            score = run_window(step)                        # bytes/sec
            tuner.observe(score)
    """

    def __init__(
        self,
        low_bytes: int = 1 << 16,
        high_bytes: int = 1 << 28,
        warmup_windows: Optional[int] = None,
        log_path: Optional[str] = None,
    ):
        self.low = math.log2(low_bytes)
        self.high = math.log2(high_bytes)
        if warmup_windows is None:
            # Reference sub-knob (parameter_manager.h:42-105):
            # AUTOTUNE_BAYES_OPT_MAX_SAMPLES caps total GP samples —
            # here the explore budget before freezing.
            warmup_windows = env.get_int(
                "AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 10
            )
        self.warmup_windows = max(1, warmup_windows)
        # Reference AUTOTUNE_WARMUP_SAMPLES: number of leading samples
        # DISCARDED before scoring (its default 3 covers cold caches);
        # ours defaults to 0 because each window already fences out its
        # compile step.
        self._discard_left = max(0, env.get_int("AUTOTUNE_WARMUP_SAMPLES", 0))
        self._windows = 0
        self._frozen: Optional[int] = None
        self._current: Optional[float] = None
        self._log_path = log_path or env.get_env(env.AUTOTUNE_LOG)
        self._native = None
        self._history: list[tuple[float, float]] = []
        from .. import native

        if native.available():
            self._native = native.Autotune(self.low, self.high)

    def threshold_bytes(self) -> int:
        if self._frozen is not None:
            return self._frozen
        if self._native is not None:
            self._current = self._native.suggest()
        else:
            # fallback: coarse grid sweep
            grid = [self.low + (self.high - self.low) * i / max(1, self.warmup_windows - 1)
                    for i in range(self.warmup_windows)]
            self._current = grid[min(self._windows, len(grid) - 1)]
        return int(2 ** self._current)

    def observe(self, score: float) -> None:
        """Report the window score (bytes/sec or images/sec)."""
        if self._frozen is not None or self._current is None:
            return
        if self._discard_left > 0:
            self._discard_left -= 1  # reference warmup sample: dropped
            return
        self._history.append((self._current, score))
        if self._native is not None:
            self._native.observe(self._current, score)
        self._windows += 1
        if self._log_path:
            with open(self._log_path, "a") as fh:
                fh.write(f"{self._windows},{2**self._current:.0f},{score}\n")
        if self._windows >= self.warmup_windows:
            self._freeze()

    def _freeze(self) -> None:
        if self._native is not None:
            best_x, best_score = self._native.best()
        else:
            best_x, best_score = max(self._history, key=lambda p: p[1])
        self._frozen = int(2 ** best_x)
        get_logger().info(
            "autotune converged: fusion threshold %d bytes (score %.3g)",
            self._frozen, best_score,
        )

    def freeze(self, threshold_bytes: int) -> None:
        """Pin the knob to a known-good value without exploration — the
        warm-start entry point for a persisted schedule
        (``sched/store.py``): ``converged`` is True immediately and no
        window is ever burned re-learning it."""
        self._frozen = int(threshold_bytes)

    @property
    def converged(self) -> bool:
        return self._frozen is not None


class AutotuneDriver:
    """Transparent window loop over :class:`FusionAutotuner`.

    The reference tunes *online*: ``ParameterManager::Update`` counts
    reduced bytes per cycle, scores a window, and flips knobs without
    user involvement (``parameter_manager.h:42-105``, ``.cc:118-170``).
    This driver gives ``TrainStep`` the same hands-off behavior: it
    owns the window bookkeeping (steps per window, wall-clock scoring
    with a sync at each boundary, compile-step exclusion) and yields the
    fusion threshold each step should trace with.

    Protocol::

        thr = driver.threshold_bytes()        # before building/running step
        out = step(...)                       # possibly a recompile
        driver.after_step(out)                # scores windows, advances

    Scores are steps/sec over the window excluding its first step (which
    pays the recompile for a new threshold — the reference excludes
    warmup samples the same way).
    """

    def __init__(self, window_steps: Optional[int] = None,
                 quant_eligible: bool = False, **tuner_kwargs):
        import time as _time

        self._time = _time
        self.tuner = FusionAutotuner(**tuner_kwargs)
        self.window_steps = window_steps or env.get_int(
            "AUTOTUNE_WINDOW",
            env.get_int("AUTOTUNE_STEPS_PER_SAMPLE", 16),
        )
        self._steps_in_window = 0
        self._t0: Optional[float] = None
        # Every closed window: its variant, score, host seconds, timed
        # steps and the 1-based numbers of its first and last timed calls.
        self.windows: list = []
        self._calls = 0
        self._first_timed = 1
        # Second knob (the reference tunes several parameters jointly,
        # parameter_manager.h:42-105): after the threshold freezes, the
        # hierarchical-allreduce lowering is probed at the winning
        # threshold and kept only if it scores better.  Categorical,
        # numerics-neutral — exactly the class of knob the reference
        # explores.  Skipped when the user pinned the env knob or the
        # world has a single host (the lowering would no-op).
        self._hier_state = "pending"   # pending -> probing -> frozen
        self._hier_value: Optional[bool] = None
        self._hier_scores: list = []
        self._hier_windows = max(1, env.get_int("AUTOTUNE_HIER_WINDOWS", 2))
        self._flat_scores: list = []
        # Third knob: int8 quantized wire on/off, probed at the frozen
        # (threshold, hierarchical) winner.  UNLIKE the first two this
        # changes numerics (lossy wire), so exploration requires the
        # explicit opt-in HVD_TPU_AUTOTUNE_EXPLORE_QUANTIZED=1 *and* a
        # build-side eligibility flag (op/compression/set support —
        # TrainStep passes it; a probe variant whose trace still raises
        # is rejected via reject_quantized()).
        self._quant_state = "pending"  # pending -> probing -> frozen
        self._quant_value: Optional[bool] = None
        self._quant_eligible = bool(quant_eligible) and env.get_bool(
            "AUTOTUNE_EXPLORE_QUANTIZED", False
        )
        self._quant_base: list = []
        self._quant_scores: list = []
        # Joint refinement (the reference explores knobs JOINTLY via one
        # Bayesian surface; sequential freezing can miss interaction
        # effects): after the quantized knob lands and CHANGED the
        # config, the hierarchical knob is re-probed once at the final
        # quantized setting and flipped if the flip scores better.
        self._refine_state = "pending"  # pending->baseline->probing->done
        self._hier_flip: Optional[bool] = None
        self._refine_base: list = []
        self._refine_scores: list = []

    def threshold_bytes(self) -> int:
        return self.tuner.threshold_bytes()

    def hierarchical(self) -> Optional[bool]:
        """Current hierarchical-lowering suggestion for the step build
        (None until the threshold knob has converged)."""
        if self._hier_state == "probing":
            return True
        if self._hier_state == "frozen":
            if self._refine_state == "probing":
                return self._hier_flip
            return self._hier_value
        return None

    def quantized(self) -> Optional[bool]:
        """Current quantized-wire suggestion for the step build (None
        until its turn in the schedule; None when frozen-off so the
        baseline compiled variant is reused, mirroring the hierarchical
        freeze contract)."""
        if self._quant_state == "probing":
            return True
        if self._quant_state == "frozen":
            return self._quant_value
        return None

    def reject_quantized(self) -> None:
        """Called by the step builder when tracing the quantized probe
        variant raises (sparse grads, unsupported op discovered at
        trace time): freeze the knob off and skip refinement."""
        self._quant_state = "frozen"
        self._quant_value = None
        self._quant_eligible = False
        if self._refine_state != "done":
            self._refine_state = "done"
        get_logger().info(
            "autotune: quantized wire rejected by the step build"
        )

    def _hier_explorable(self) -> bool:
        """Whether the hierarchical allreduce can do anything: the knob is
        not pinned, and the world has a host grid
        (``ops/collectives.py`` ``host_groups``: several hosts of equal
        rank counts, or a multi-domain ``HVD_TPU_TOPO``; the JAX package
        asks for several hosts of several ranks)."""
        # empty string == unset (get_bool's semantics everywhere else)
        if env.get_env(env.HIERARCHICAL_ALLREDUCE) not in (None, ""):
            return False  # user pinned the knob: honor it
        try:
            from .. import runtime
            from ..ops.collectives import host_groups

            return runtime.is_initialized() and host_groups() is not None
        except Exception:
            return False

    def _collapse_static(self) -> None:
        """Freeze knobs whose exploration is statically pointless the
        moment their turn arrives — no window may be burned discovering
        a knob that cannot move (quant without the opt-in/eligibility,
        refinement without a kept quant)."""
        if (self._hier_state == "frozen"
                and self._quant_state == "pending"
                and not self._quant_eligible):
            self._quant_state = "frozen"
            self._quant_value = None
        if (self._quant_state == "frozen"
                and self._refine_state == "pending"
                and (self._quant_value is not True
                     or not self._hier_explorable())):
            self._refine_state = "done"

    def _advance_hier(self, score: float) -> None:
        """Feed a closed window's score to the hierarchical knob state
        machine (runs only after the threshold tuner froze)."""
        try:
            self._advance_hier_inner(score)
        finally:
            self._collapse_static()

    def _advance_hier_inner(self, score: float) -> None:
        if self._hier_state == "pending":
            if not self._hier_explorable():
                self._hier_state = "frozen"
                self._hier_value = None
                return
            # frozen-flat baseline: same window count as the probe so
            # the comparison is noise-symmetric (mean vs mean)
            self._flat_scores.append(score)
            if len(self._flat_scores) >= self._hier_windows:
                self._hier_state = "probing"
            return
        if self._hier_state == "probing":
            self._hier_scores.append(score)
            if len(self._hier_scores) >= self._hier_windows:
                flat = sum(self._flat_scores) / len(self._flat_scores)
                hier = sum(self._hier_scores) / len(self._hier_scores)
                kept = hier > flat
                # A rejected probe freezes to None, NOT False: the flat
                # baseline's compiled variant is keyed on None, and the
                # eviction must keep it rather than force a redundant
                # recompile of an identical program.
                self._hier_value = True if kept else None
                self._hier_state = "frozen"
                get_logger().info(
                    "autotune: hierarchical allreduce %s (flat %.3g vs "
                    "hierarchical %.3g steps/s, %d windows each)",
                    "kept" if kept else "rejected", flat, hier,
                    self._hier_windows,
                )

    def _advance_quant(self, score: float) -> None:
        """Quantized-wire knob state machine (runs after the
        hierarchical knob froze)."""
        try:
            self._advance_quant_inner(score)
        finally:
            self._collapse_static()

    def _advance_quant_inner(self, score: float) -> None:
        if self._quant_state == "pending":
            if not self._quant_eligible:
                self._quant_state = "frozen"
                self._quant_value = None
                return
            self._quant_base.append(score)
            if len(self._quant_base) >= self._hier_windows:
                self._quant_state = "probing"
            return
        if self._quant_state == "probing":
            self._quant_scores.append(score)
            if len(self._quant_scores) >= self._hier_windows:
                base = sum(self._quant_base) / len(self._quant_base)
                quant = sum(self._quant_scores) / len(self._quant_scores)
                kept = quant > base
                self._quant_value = True if kept else None
                self._quant_state = "frozen"
                get_logger().info(
                    "autotune: quantized wire %s (fp %.3g vs int8 %.3g "
                    "steps/s, %d windows each)",
                    "kept" if kept else "rejected", base, quant,
                    self._hier_windows,
                )

    def _advance_refine(self, score: float) -> None:
        """One joint-refinement round-trip: re-probe the hierarchical
        knob at the FINAL quantized setting (sequential freezing probed
        it before the quantized knob existed, which misses interaction
        effects — the reference's joint Bayesian surface would not)."""
        if self._refine_state == "pending":
            # only worth a probe when the quantized knob changed the
            # config and the hierarchical knob is actually explorable
            if self._quant_value is not True or not self._hier_explorable():
                self._refine_state = "done"
                return
            self._hier_flip = None if self._hier_value else True
            self._refine_state = "baseline"
            # fall through: this window already ran the current config
        if self._refine_state == "baseline":
            self._refine_base.append(score)
            if len(self._refine_base) >= self._hier_windows:
                self._refine_state = "probing"
            return
        if self._refine_state == "probing":
            self._refine_scores.append(score)
            if len(self._refine_scores) >= self._hier_windows:
                base = sum(self._refine_base) / len(self._refine_base)
                flip = sum(self._refine_scores) / len(self._refine_scores)
                if flip > base:
                    get_logger().info(
                        "autotune: joint refinement flipped hierarchical "
                        "to %s at the quantized winner (%.3g vs %.3g "
                        "steps/s)", self._hier_flip, flip, base,
                    )
                    self._hier_value = self._hier_flip
                self._refine_state = "done"

    @property
    def converged(self) -> bool:
        return (
            self.tuner.converged
            and self._hier_state == "frozen"
            and self._quant_state == "frozen"
            and self._refine_state == "done"
        )

    @staticmethod
    def _sync(out) -> None:
        """The window fence: wait for the step's device work
        (``torch.cuda.synchronize`` of ``out``'s card; a host read of
        ``out`` on the CPU)."""
        import torch

        if not torch.is_tensor(out):
            return
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        else:
            out.reshape(-1)[:1].tolist()

    def after_step(self, out, settled: bool = True) -> None:
        """Advance the window; ``out`` is any step output to sync on.
        ``settled`` is False for a step that is not what the variant's
        later steps will be (a warm-up step or the capture of a new
        variant's graph): the window's clock restarts after it, so a
        window times only settled steps.  In a world of several ranks
        every rank follows rank 0 (module docstring)."""
        if self.converged:
            return
        settled = world_settled(settled)
        self._calls += 1
        self._steps_in_window += 1
        if self._steps_in_window == 1 or not settled:
            # First step of a window (the JAX package's compile step), or
            # an unsettled one: fence it out of the timed region.
            self._sync(out)
            self._t0 = self._time.perf_counter()
            self._steps_in_window = 1
            self._first_timed = self._calls + 1
            return
        if self._steps_in_window >= self.window_steps:
            self._sync(out)
            dt = self._time.perf_counter() - self._t0
            timed_steps = self._steps_in_window - 1
            score = world_score(timed_steps / max(dt, 1e-9))
            self.windows.append({
                "threshold": self.tuner.threshold_bytes(),
                "hierarchical": self.hierarchical(),
                "quantized": self.quantized(),
                "score": score, "seconds": dt, "timed_steps": timed_steps,
                "calls": (self._first_timed, self._calls),
            })
            self._observe_window(score)
            self._steps_in_window = 0
            self._t0 = None

    def _observe_window(self, score: float) -> None:
        """Feed one closed window's score to the knob schedule:
        threshold -> hierarchical -> quantized -> joint refinement.
        Factored out of :meth:`after_step` so the schedule is testable
        on synthetic score surfaces."""
        threshold = self.tuner.threshold_bytes()
        hier = self.hierarchical()
        quant = self.quantized()
        if not self.tuner.converged:
            self.tuner.observe(score)
            if self.tuner.converged and not self._hier_explorable():
                # static check: don't burn a window discovering it
                self._hier_state = "frozen"
                self._hier_value = None
            self._collapse_static()
        elif self._hier_state != "frozen":
            self._advance_hier(score)
        elif self._quant_state != "frozen":
            self._advance_quant(score)
        elif self._refine_state != "done":
            self._advance_refine(score)
        self._record_window(threshold, score, hier, quant)

    @staticmethod
    def _record_window(threshold: int, score: float,
                       hier: Optional[bool] = None,
                       quant: Optional[bool] = None) -> None:
        """Window records land on the timeline (reference
        ParameterManager's cycle records): one event per closed window
        with the explored threshold, lowering choice, and steps/s
        score — flat-baseline vs hier-probe windows must be tellable
        apart in the trace."""
        try:
            from .. import runtime

            rt = runtime.get_runtime() if runtime.is_initialized() else None
            tl = getattr(rt, "timeline", None)  # no timeline in the port yet
        except Exception:
            tl = None
        if tl is not None:
            lowering = "hier" if hier else "flat"
            wire = "int8" if quant else "fp"
            tl.record_op(
                f"autotune threshold={threshold} lowering={lowering} "
                f"wire={wire} score={score:.2f}steps/s",
                "AUTOTUNE_WINDOW", threshold,
            )
