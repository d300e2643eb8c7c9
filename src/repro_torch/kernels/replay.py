"""Kernel outputs that a residency plan holds across recomputation.

A training forward under a residency plan (``models.remat``) runs its layers
in recompute regions; in the recomputation a kernel whose output class the
plan keeps (or offloads) is not launched again: the output it gave in the
first forward is handed back instead.  The kernels' autograd functions talk
to the plan through the *keeper* this module holds for the current thread:

* ``keeper.lookup(name)`` — the kept output of class ``name`` of the current
  layer, when this is a recomputation and the plan holds that class; else
  None (launch the kernel);
* ``keeper.keep(name, value)`` — after a launch in a first forward: hold
  ``value`` (a tuple of tensors) if the plan holds the class;
* ``keeper.release(name_key)`` — from the kernel's backward, the last reader.

With no keeper installed (serving, or a plan that recomputes nothing) the
kernels launch every time and hold nothing.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["current", "installed"]

_local = threading.local()


def current():
    """The keeper of this thread, or None."""
    return getattr(_local, "keeper", None)


@contextlib.contextmanager
def installed(keeper):
    """Install ``keeper`` for this thread for the duration of the block."""
    prev = current()
    _local.keeper = keeper
    try:
        yield keeper
    finally:
        _local.keeper = prev
