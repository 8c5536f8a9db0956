"""Production mesh construction.

Functions, not module-level constants: importing this module touches no
process group or device state. The caller starts the process group
first: a ``fake`` world for the dry run, ``gloo`` processes for the CPU
tests, ``nccl`` on the cards.

Single pod : (data=16, model=16)            - 256 devices.
Multi-pod  : (pod=2, data=16, model=16)     - 512 devices across 2 pods;
the "pod" axis carries pure data parallelism (params replicated per pod,
grads all-reduced across pods).
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device=DEFAULT_DEVICE) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   device=DEFAULT_DEVICE) -> DeviceMesh:
    """Small mesh over the caller's world (data * model [* pod] ranks)."""
    dev = resolve_device(device).type
    if pod:
        return init_device_mesh(dev, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(dev, (data, model),
                            mesh_dim_names=("data", "model"))
