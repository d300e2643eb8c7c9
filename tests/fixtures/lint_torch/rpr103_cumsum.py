"""Fixture: RPR103 cumsum-parity.  Linted as ``core/eval_batch.py``
(a parity-critical module)."""
import numpy as np
import torch


def bad(a):
    return torch.cumsum(torch.as_tensor(a), 0)  # RPR103: a parallel scan


def bad_method(a):
    t = torch.as_tensor(a)
    return t.cumsum(0)  # RPR103: the same scan through the tensor's method


def good_numpy(a):
    return np.cumsum(a)  # the sequential reference is the parity anchor


def good_array_method(a):
    arr = np.asarray(a)
    return arr.cumsum()  # a NumPy array's cumsum: sequential too
