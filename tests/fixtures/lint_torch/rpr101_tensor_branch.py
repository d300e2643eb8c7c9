"""Fixture: RPR101 tensor-branch.  Linted as ``core/fixture.py``."""
import torch


class _Launch:
    def __init__(self, n_walks, perturb):
        self.W = n_walks
        self.perturb = perturb
        self.state = {"stop": torch.zeros(n_walks, dtype=torch.bool),
                      "it": torch.zeros(n_walks)}
        self.graph = None

    def capture(self):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            self.round(0)
        finally:
            graph.capture_end()
        self.graph = graph

    def round(self, i):
        st = {k: v[i] for k, v in self.state.items()}
        if st["stop"]:  # RPR101: a slice of the state's tensors
            return
        it = st["it"] + 1
        assert it.min() >= 0  # RPR101: an assert reads the device
        done = it > 3 if it.sum() > 0 else it < 0  # RPR101: ternary on a tensor
        if i > 0:
            # a Python int: decided once, at capture, legitimately
            it = it + i
        if self.perturb:
            # a bool attribute, fixed for the launch
            it = it * 2
        if it.shape[0] > 1:
            # static metadata
            it = it[:1]
        mask = None
        if mask is None:
            # a structure check
            mask = torch.ones_like(it)
        st["it"].copy_(torch.where(done, it * mask, st["it"]))


def host_side(x: torch.Tensor):
    # not captured: a branch on a tensor is an ordinary host decision here
    if x.sum() > 0:
        return x
    return -x


def record_steps(x: torch.Tensor, n: int):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(x, n)
    return graph


def step(x, n):
    while x.max() > 1.0:  # RPR101: a loop on a tensor
        x = x / 2
    for _ in range(n):
        # a Python loop count
        x = x + 1
    return x
