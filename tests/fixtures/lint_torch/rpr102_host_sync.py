"""Fixture: RPR102 host-sync.  Linted as ``core/fixture.py``."""
import numpy as np
import torch


class Launch:
    def __init__(self, n_walks):
        self.W = n_walks
        self.buf = torch.zeros(n_walks)
        self.graph = None

    def capture(self):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.round(3)
        self.graph = graph

    def round(self, n):
        x = self.buf * 2
        best = x.max().item()  # RPR102: a device read in the round
        rows = np.asarray(x)  # RPR102: a copy to the host
        first = float(x[0])  # RPR102: a scalar read
        host = x.cpu()  # RPR102: a copy to the host
        w = int(self.W)  # an int attribute: no sync
        k = len(self.buf)  # metadata
        m = int(x.shape[0])  # metadata
        scale = float(n)  # a Python number
        self.buf.copy_(x * scale + w + k + m)
        return best, rows, first, host


def report(buf: torch.Tensor):
    # not captured: the host reads the result after the replays
    return buf.sum().item(), buf.tolist()
