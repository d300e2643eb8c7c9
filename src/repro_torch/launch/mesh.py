"""Production mesh factories.

``make_production_mesh`` is a FUNCTION (importing this module touches no
device and no process group): 16×16 (data, model) single pod, 2×16×16
(pod, data, model) across two pods, as ``DeviceMesh``es of the default
process group (which must hold as many ranks as the mesh; the dry run
makes a fake group of that size, ``launch.dryrun``).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_mesh", "production_shape"]


def production_shape(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device_type: str = "cuda"):
    """Arbitrary mesh (tests / elastic re-mesh) over the default process
    group, on ``device_type`` ("cuda", or "cpu" for gloo and fake groups)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
