"""Prefill traffic: requests served one at a time through the launcher's
``serve(..., gen=1)`` (the prompt's prefill and its first token), by a
closed loop of one client; a request is ``batch`` prompts of one length
(1 where the traffic file names none).

Set-up builds the port's decoder, copies the benchmark's weights into it and
serves one prompt of every length the traffic lists, longest first.  The
window then cycles the lengths in an order drawn from the seed, each prompt
drawn from the seed; a request is due when the client hands it over (just
after the previous one's first token came back) and done when its first
token is on the host.  With ``--trace 1`` the first ``profile_requests`` are
profiled.  Once the window has closed and the model is freed,
``checked_requests`` of the requests served (the longest among them, the
rest drawn from the seed) are run through the float32 reference
(``reference/prefill.py``).  Each served token is judged by how far the
reference's logit of it lies below the reference's best (``token_gap``),
and the logits the prefill step picked it from by their error against the
reference's (``logit_err``): one token a request can agree with the
reference where a lower precision has moved every logit.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..harness import port, weights
from ..harness.record import Record, Unit
from ..harness.trace import Profiled
from ..reference import prefill as ref_prefill


def order(traffic: dict, seed: int) -> list:
    """The cycle of lengths this seed serves: every length once, in an order
    drawn from the seed."""
    rng = np.random.default_rng(weights.part_seed(seed, "order"))
    lengths = traffic["lengths"]
    return [lengths[i] for i in rng.permutation(len(lengths))]


def prompt(rec: Record, seed: int, r: int, length: int, device) -> torch.Tensor:
    """Request ``r``'s prompts, (batch, length)."""
    return weights.token_rows(seed, "prompt", r, rec.traffic.get("batch", 1), length,
                              rec.arch.vocab, device)


def run(rec: Record, seed: int, seconds: float, trace: bool, device, t_start: float) -> None:
    a, t = rec.arch, rec.traffic
    if t["clients"] != 1 or t["gen"] != 1:
        raise ValueError("this kind serves one closed-loop client its first token")
    t0 = time.perf_counter()
    cfg, model = port.build_server(rec.config, a, seed, device)
    t1 = time.perf_counter()
    rows = t.get("batch", 1)
    for j, length in enumerate(sorted(t["lengths"], reverse=True)):
        port.first_tokens(cfg, model, weights.token_rows(seed, "warm", j, rows, length, a.vocab,
                                                         device), device)
    cycle = order(t, seed)
    served, prof = [], None
    t_w = end = rec.steady_from = time.perf_counter()
    rec.notes["setup"] = {"imports_s": t0 - t_start, "build_s": t1 - t0, "warm_s": t_w - t1}
    rec.setup_s = t_w - t_start
    end += seconds
    while True:
        r = len(rec.units)
        length = cycle[r % len(cycle)]
        if trace and r == 0:
            prof = Profiled(device).__enter__()
        ids = prompt(rec, seed, r, length, device)
        due = time.perf_counter()
        try:
            out, ok = port.first_tokens(cfg, model, ids, device), True
        except torch.OutOfMemoryError as e:       # a request the system failed
            out, ok = None, False
            rec.notes.setdefault("errors", []).append(f"request {r} ({length}): {e}")
        rec.units.append(Unit(due, time.perf_counter(), rows * length, rows, length, ok))
        served.append(out)
        if prof is not None and len(rec.units) == t["profile_requests"]:
            prof.__exit__(None, None, None)
            rec.trace, rec.profiled, prof = prof.trace, len(rec.units), None
            gc.collect()                            # the profiler's records
            rec.steady_from = time.perf_counter()
            end = rec.steady_from + seconds         # the window runs on past the profile
        if time.perf_counter() >= end and prof is None:
            break
    rec.window_s = rec.units[-1].done - t_w
    if torch.device(device).type == "cuda":
        rec.device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    picks = sample([u.seq if u.ok else None for u in rec.units], seed, t["checked_requests"])
    prompts = [p for r in picks for p in prompt(rec, seed, r, rec.units[r].seq, device)]
    (ref,) = ref_prefill.last_logits(a, seed, prompts, device)
    tokens = [tok for r in picks for tok in served[r][0]]
    logits = [row for r in picks for row in served[r][1]]
    gaps, errs = token_gaps(ref, tokens), logit_errors(ref, logits)
    rec.notes["checked"] = {"requests": picks, "lengths": [rec.units[r].seq for r in picks],
                            "gaps": gaps, "logit_errs": errs}
    rec.check("token_gap", max(gaps), rec.limits["token_gap"])
    rec.check("logit_err", max(errs), rec.limits["logit_err"])


def sample(lengths: list, seed: int, k: int) -> list:
    """The requests to check, by their place in the window (``lengths``:
    each request's prompt length, None for one that failed): the first of
    the longest served, and ``k - 1`` drawn from the seed among the others
    served."""
    ok = [r for r, n in enumerate(lengths) if n is not None]
    longest = max(ok, key=lambda r: (lengths[r], -r))
    rest = [r for r in ok if r != longest]
    rng = np.random.default_rng(weights.part_seed(seed, "sample"))
    k = min(len(rest), k - 1)
    return [longest] + sorted(int(r) for r in rng.choice(rest, size=k, replace=False))


def token_gaps(ref: list, tokens: list) -> list:
    """Per checked prompt, the reference's best logit less its logit of the
    token served."""
    return [float(lg.max() - lg[tok]) for tok, lg in zip(tokens, ref)]


def logit_errors(ref: list, logits: list) -> list:
    """Per checked prompt, ``||l - l_ref|| / ||l_ref - mean(l_ref)||`` over
    the vocabulary: the error of the served last-position logits ``l`` (the
    padded vocabulary cut off) against the spread of the reference's."""
    out = []
    for lr, lg in zip(ref, logits):
        d = lg[:lr.shape[0]].to(lr.device, torch.float32) - lr
        out.append(float(d.norm() / (lr - lr.mean()).norm()))
    return out
