"""``cudaMalloc`` calls per profiled request: the program's counter
``alloc.device_allocs``, the CUDA caching allocator's ``num_device_alloc``
read at the start and the end of each request's span (None off a CUDA
device, which has no such allocator)."""
from bench.harness.program import count_per_unit


def read(rec):
    return count_per_unit(rec, "repro.serve.request", "alloc.device_allocs")
