"""Fault tolerance & elasticity utilities.

* ``run_with_recovery`` — the production step loop: periodic async
  checkpoints, automatic restore-and-replay after a (simulated or real)
  failure, deterministic data replay from the step counter.  The port's
  training step updates the state in place, so a failure before the first
  checkpoint is recovered by ``reinit`` (rebuild the initial state, e.g. from
  the seed), or raises.
* ``shrink_mesh_plan`` — elastic scale-down: given a device loss, propose the
  largest still-rectangular mesh and the checkpoint re-shard that moves the
  state onto it (restore handles the actual re-placement).
* ``straggler_rebalance`` — the paper's own mechanism applied to stragglers:
  feed measured per-stage step times back into the HDATS planner as
  heterogeneous processor speeds and re-solve the stage map.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from . import checkpoint as ckpt_lib

__all__ = ["run_with_recovery", "shrink_mesh_plan", "straggler_rebalance", "FailureInjector"]


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure simulation for tests: raises at given steps."""

    fail_at: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_with_recovery(
    *,
    init_state,
    train_step: Callable,
    batch_at: Callable[[int], dict],
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    injector: FailureInjector | None = None,
    max_restarts: int = 3,
    on_metrics: Callable[[int, dict], None] | None = None,
    reinit: Callable[[], Any] | None = None,
):
    """Run `n_steps`, checkpointing every `ckpt_every`; on failure, restore the
    latest checkpoint into the state and replay (data is a pure function of
    step, so replay is bitwise-deterministic); with no checkpoint yet, the
    state is ``reinit()``."""
    cp = ckpt_lib.Checkpointer(ckpt_dir)
    state = init_state
    restarts = 0
    step = int(state.step)
    while step < n_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            state, metrics = train_step(state, batch_at(step))
            step = int(state.step)
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % ckpt_every == 0:
                cp.save_async(step, state)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            cp.wait()
            last = ckpt_lib.latest_step(ckpt_dir)
            if last is not None:
                state, _ = ckpt_lib.restore(ckpt_dir, state)
            elif reinit is not None:
                state = reinit()
            else:
                raise
            step = int(state.step)
    cp.wait()
    return state, restarts


def shrink_mesh_plan(n_devices_left: int, *, model_axis: int = 16) -> dict:
    """Largest (data, model) mesh fitting the surviving devices, keeping the
    model axis intact (TP degree is baked into weight shapes); data axis
    shrinks.  Returns the new shape + the global-batch rescale factor."""
    if n_devices_left < model_axis:
        # degrade TP too: halve until it fits
        while model_axis > 1 and n_devices_left < model_axis:
            model_axis //= 2
    data_axis = max(1, n_devices_left // model_axis)
    return {
        "mesh_shape": (data_axis, model_axis),
        "axis_names": ("data", "model"),
        "devices_used": data_axis * model_axis,
        "batch_scale": data_axis,  # relative units; caller rescales global batch
    }


def straggler_rebalance(
    layer_costs: np.ndarray,          # (L,) planned per-layer cost
    stage_of_layer: np.ndarray,       # (L,) current stage map
    measured_stage_time: np.ndarray,  # (S,) observed per-stage wall time
) -> np.ndarray:
    """Re-balance pipeline stages around stragglers using the HDATS greedy
    construction: observed slowdown per stage becomes the heterogeneous
    processor speed PT(v, P) and layers are re-assigned contiguously so the
    bottleneck stage time is minimized (longest-processing-time heuristic
    under the contiguity constraint)."""
    n_stages = len(measured_stage_time)
    planned = np.array([layer_costs[stage_of_layer == s].sum() for s in range(n_stages)])
    planned = np.maximum(planned, 1e-9)
    slowdown = measured_stage_time / planned          # >1 ⇒ straggler
    # contiguous partition minimizing max(stage_cost * slowdown) via DP
    L = len(layer_costs)
    prefix = np.concatenate([[0.0], np.cumsum(layer_costs)])
    NEG = float("inf")
    best = np.full((n_stages + 1, L + 1), NEG)
    cut = np.zeros((n_stages + 1, L + 1), dtype=int)
    best[0, 0] = 0.0
    for s in range(1, n_stages + 1):
        for j in range(s, L - (n_stages - s) + 1):
            for i in range(s - 1, j):
                cost = (prefix[j] - prefix[i]) * slowdown[s - 1]
                val = max(best[s - 1, i], cost)
                if val < best[s, j]:
                    best[s, j] = val
                    cut[s, j] = i
    new_map = np.zeros(L, dtype=int)
    j = L
    for s in range(n_stages, 0, -1):
        i = cut[s, j]
        new_map[i:j] = s - 1
        j = i
    return new_map
