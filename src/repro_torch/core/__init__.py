"""HDATS core — the paper's contribution.

Data allocation + task scheduling on heterogeneous multiprocessor systems
under memory constraints (Ding et al., 2022): MDFG instances, exact/approx
schedule evaluation, greedy construction (Alg. 1), tabu search (Alg. 2),
memory update (Alg. 3), the load-balancing baseline and the ILP model.

The supported solver surface is :func:`repro_torch.solve` (see ``core/api.py``);
import the raw search functions (``tabu_search``, ``construct_greedy``,
``load_balance``, ``brute_force_optimum``) from their submodules
(``repro_torch.core.tabu`` etc.) when a test needs them.
"""
from .mdfg import InfeasibleInstanceError, Instance, random_instance, validate_instance
from .solution import (
    Schedule,
    Solution,
    data_lifetimes,
    durations,
    exact_schedule,
    heads_tails,
    memory_feasible,
    memory_peaks,
)
from .eval_batch import (
    BatchEval,
    BatchEvaluator,
    MoveBatch,
    PackedSolutions,
    approx_eval_moves,
    batch_evaluate,
    pack_solutions,
)
from .greedy import STRATEGIES
from .memory_update import memory_update
from .tabu import (
    Move,
    MultiWalkResult,
    TSEvent,
    TSParams,
    TSResult,
    apply_move,
    critical_blocks,
    tabu_multiwalk,
)
from .device_search import DeviceConfig, device_multiwalk, solve_instances
from .ilp import build_ilp
from .api import (
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
    "InfeasibleInstanceError",
    "Instance",
    "random_instance",
    "validate_instance",
    "Schedule",
    "Solution",
    "data_lifetimes",
    "durations",
    "exact_schedule",
    "heads_tails",
    "memory_feasible",
    "memory_peaks",
    "BatchEval",
    "BatchEvaluator",
    "MoveBatch",
    "PackedSolutions",
    "approx_eval_moves",
    "batch_evaluate",
    "pack_solutions",
    "STRATEGIES",
    "memory_update",
    "Move",
    "MultiWalkResult",
    "TSEvent",
    "TSParams",
    "TSResult",
    "apply_move",
    "critical_blocks",
    "tabu_multiwalk",
    "DeviceConfig",
    "device_multiwalk",
    "solve_instances",
    "build_ilp",
    "Budget",
    "Callbacks",
    "SolveReport",
    "Solver",
    "solve",
    "register_solver",
    "get_solver",
    "list_solvers",
]
