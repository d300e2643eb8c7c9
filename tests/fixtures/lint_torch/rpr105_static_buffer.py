"""Fixture: RPR105 static-buffer-rebind.  Linted as ``core/fixture.py``."""
import torch


class Launch:
    def __init__(self, n):
        self.n = n
        self.state = torch.zeros(n)
        self.scale = torch.ones(n)
        self.log = []
        self.graph = None

    def capture(self):
        self.scale = torch.full((self.n,), 2.0)  # before the capture: recorded
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        self.round()
        graph.capture_end()
        self.state = torch.zeros(self.n)  # RPR105: rebound after the capture
        self.graph = graph

    def round(self):
        self.state.mul_(self.scale)

    def load(self, x):
        self.state = x.clone()  # RPR105: the replay keeps the old buffer

    def load_in_place(self, x):
        self.state.copy_(x)  # fills the captured buffer

    def set_scale(self, v):
        self.scale[...] = v  # fills it by subscript

    def note(self, msg):
        self.log = self.log + [msg]  # not read by the round
