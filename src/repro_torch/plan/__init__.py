"""The HDATS planner of the port: cost model, MDFG extraction and the
residency / pipeline planners (the reference's ``repro.plan``, with the
device's constants as a parameter and the plan lowered for PyTorch)."""
from .cost import (
    H100, HBM_BW, HBM_BYTES, HOST_BW, ICI_BW, PEAK_FLOPS, TPU_V5E, Hardware,
    hbm_activation_budget, layer_costs, param_state_bytes,
)
from .extract import ACT_CLASSES, contiguous_stage_map, pipeline_instance, residency_instance
from .planner import ResidencyPlan, plan_pipeline, plan_residency, plan_residency_lb

__all__ = [
    "H100", "TPU_V5E", "Hardware", "contiguous_stage_map",
    "HBM_BW", "HBM_BYTES", "HOST_BW", "ICI_BW", "PEAK_FLOPS",
    "hbm_activation_budget", "layer_costs", "param_state_bytes",
    "ACT_CLASSES", "pipeline_instance", "residency_instance",
    "ResidencyPlan", "plan_pipeline", "plan_residency", "plan_residency_lb",
]
