"""Seconds of the residency planner (``plan.plan_residency``, the paper's
HDATS search) in set-up: the host clock around the launcher's call."""


def read(rec):
    return rec.spans.get("plan_s")
