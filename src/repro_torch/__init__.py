"""repro_torch — the PyTorch/CUDA port of the HDATS scheduler (Ding et al.,
2022: data allocation + task scheduling on heterogeneous multiprocessors
under memory constraints).

The supported solver surface lives here::

    from repro_torch import solve, Budget

    report = solve(instance, method="tabu_multiwalk", budget=Budget(max_iters=200))
    report.makespan, report.solution, report.history

Exact schedule evaluation runs on the GPU by default (``backend="torch"``,
``torch_device="cuda"``) through the hand-written schedule-DP kernel in
``repro_torch.kernels``; pass ``torch_device="cpu"`` or ``backend="numpy"``
to stay on the host.  The package imports ``torch`` and ``numpy`` only.
"""
from .core.api import (
    Budget,
    Callbacks,
    SolveReport,
    Solver,
    get_solver,
    list_solvers,
    register_solver,
    solve,
)

__all__ = [
    "Budget",
    "Callbacks",
    "SolveReport",
    "Solver",
    "solve",
    "register_solver",
    "get_solver",
    "list_solvers",
]
