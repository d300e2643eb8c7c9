"""Training traffic: the launcher's trainer (``launch.train.build_trainer``,
with the traffic's planner and optimizer), then the benchmark's own loop over
``Trainer.step_fn`` on token batches drawn from the seed, every row distinct.

Set-up builds the trainer, copies the benchmark's weights into it and runs
the first ``checked_steps`` steps through the same call and feed as the
window; they warm every shape the window uses.  What the check needs from
them is read as they pass: each step's loss, each leaf's first gradient
from the optimizer's first moment (before clipping, by the step's reported
global norm) and each leaf's change after the last of them.  The window
then runs steps on the same trainer for ``--seconds``; with ``--trace 1`` the
first ``profile_steps`` of them are profiled.  Once the window has closed and
the program is freed, the float32 reference (``reference/train.py``) runs
the checked steps from the same weights and batches.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from ..harness import port, weights
from ..harness.record import Record, Unit
from ..harness.trace import Profiled
from ..reference import train as ref_train


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def batch(rec: Record, seed: int, step: int, device) -> dict:
    t = rec.traffic
    ids = weights.token_rows(seed, "train", step, t["batch"], t["seq"] + 1, rec.arch.vocab,
                             device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _hyper(traffic: dict) -> dict:
    hp = dict(traffic["optimizer"])
    port_hp = port.adamw_defaults()
    wrong = {k: (port_hp[k], hp[k]) for k in port_hp if port_hp[k] != hp[k]}
    if wrong:
        raise ValueError(f"the launcher's AdamW differs from the traffic file's "
                         f"(launcher, file): {wrong}")
    return hp


def _leaf_gaps(prog: dict, ref: dict, keep) -> list[tuple[float, str]]:
    """Each kept leaf's |prog - ref| over the larger of its reference norm
    and the median kept leaf's, smallest first."""
    kept = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in kept)
    return sorted((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in kept)


def run(rec: Record, seed: int, seconds: float, trace: bool, device, t_start: float) -> None:
    a, t = rec.arch, rec.traffic
    hp = _hyper(t)
    t0 = time.perf_counter()
    rec.notes["setup"] = {"imports_s": t0 - t_start}
    tr = port.build_trainer(rec.config, t, a, seed, device, rec.spans)
    _sync(device)
    rec.notes["setup"]["build_trainer_s"] = time.perf_counter() - t0
    state, prog, check_s = tr.state, {"losses": []}, 0.0
    for step in range(1, t["checked_steps"] + 1):
        state, m = tr.step_fn(state, batch(rec, seed, step, device))
        prog["losses"].append(m["loss"])
        if step == 1:
            _sync(device)                   # the step's own time stays in set-up
            t0 = time.perf_counter()
            gn = float(m["grad_norm"])
            clip = min(1.0, hp["clip_norm"] / max(gn, 1e-9))
            moment = port.leaf_view(a, tr.model, state.opt_state["m"])
            prog["grad_norms"] = {k: float(torch.linalg.vector_norm(v)) / ((1 - hp["b1"]) * clip)
                                  for k, v in moment.items()}
            check_s += time.perf_counter() - t0
    _sync(device)
    t0 = time.perf_counter()
    prog["losses"] = [float(x) for x in prog["losses"]]
    with torch.no_grad():
        prog["change_norms"] = ref_train.change_norms(
            a, seed, port.leaf_view(a, tr.model, dict(tr.model.named_parameters())))
    _sync(device)
    check_s += time.perf_counter() - t0

    t_w = end = rec.steady_from = time.perf_counter()
    rec.setup_s = t_w - t_start - check_s
    end += seconds
    losses, step, prof = [], t["checked_steps"], None
    while True:
        if trace and not rec.units:
            prof = Profiled(device).__enter__()
        due = time.perf_counter()
        step += 1
        state, m = tr.step_fn(state, batch(rec, seed, step, device))
        losses.append(m["loss"])
        rec.units.append(Unit(due, time.perf_counter(), t["batch"] * t["seq"], t["batch"],
                              t["seq"]))
        if prof is not None and len(rec.units) == t["profile_steps"]:
            prof.__exit__(None, None, None)
            rec.trace, rec.profiled, prof = prof.trace, len(rec.units), None
            gc.collect()                            # the profiler's records
            rec.steady_from = time.perf_counter()
            end = rec.steady_from + seconds         # the window runs on past the profile
        if time.perf_counter() >= end and prof is None:
            break
    _sync(device)
    rec.units[-1].done = time.perf_counter()
    rec.window_s = rec.units[-1].done - t_w
    for u, ok in zip(rec.units, torch.stack(losses).isfinite().tolist()):
        u.ok = ok
    if torch.device(device).type == "cuda":
        rec.device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    rec.notes["plan"] = None if tr.plan is None else {
        "scan_group": tr.plan.scan_group, "save": list(tr.plan.save_names),
        "offload": list(tr.plan.offload_names)}
    rec.notes["steps"] = len(rec.units)
    del tr, state, m, losses
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    batches = [(b["tokens"], b["labels"]) for b in
               (batch(rec, seed, s, device) for s in range(1, t["checked_steps"] + 1))]
    ref = ref_train.steps(a, seed, batches, hp, t["z_loss"], device)
    judge(rec, prog, ref)


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared, each (value, leaf or None).

    * ``loss_gap``: the widest loss gap over the checked steps;
    * ``grad_gap``: the 90th-percentile leaf's gap in its first gradient's
      norm.  Not the worst leaf's: that is a MoE router's on every seed,
      whose gradient moves with the tokens whose k-th and (k+1)-th experts
      swap under any rounding, bf16 and float8 alike;
    * ``update_gap``: the worst leaf's gap in its change's norm after the
      checked steps, leaving out a leaf whose reference gradient is under a
      thousandth of the median leaf's (its change is round-off under Adam).
    """
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grads = _leaf_gaps(prog["grad_norms"], g_ref, lambda k: True)
    loss = max(abs(p - r) for p, r in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": (loss, None),
            "grad_gap": grads[int(0.9 * len(grads))],
            "update_gap": _leaf_gaps(prog["change_norms"], ref["change_norms"],
                                     lambda k: g_ref[k] >= 1e-3 * g_med)[-1]}


def spread(prog: dict, ref: dict) -> dict:
    """What moves the numbers: the loss gap step by step, and the leaves'
    gaps at their median, 90th percentile and worst (with the worst leaf),
    with and without the routers."""
    out = {"loss_steps": [p - r for p, r in zip(prog["losses"], ref["losses"])]}
    for key, p, r in (("grad", prog["grad_norms"], ref["grad_norms"]),
                      ("update", prog["change_norms"], ref["change_norms"])):
        for tag, keep in (("all", lambda k: True), ("no_router", lambda k: "router" not in k)):
            gaps = _leaf_gaps(p, r, keep)
            out[f"{key}_{tag}"] = [gaps[len(gaps) // 2][0], gaps[int(0.9 * len(gaps))][0],
                                   *gaps[-1]]
    return out


def judge(rec: Record, prog: dict, ref: dict) -> None:
    rec.notes["loss_ref"], rec.notes["loss_prog"] = ref["losses"], prog["losses"]
    rec.notes["spread"] = spread(prog, ref)
    for name, (value, leaf) in numbers(prog, ref).items():
        rec.check(name, value, rec.limits[name])
        if leaf is not None:
            rec.notes[f"{name}_leaf"] = leaf
