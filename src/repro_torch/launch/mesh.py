"""Meshes and the H100's constants (the port of ``repro.launch.mesh``).

Both mesh builders are functions, so importing this module starts no
process group.  ``make_production_mesh`` lays the current process group
(a world of 256 or 512 ranks: the dry run's fake group, or a real
cluster) out as the reference's production meshes.  ``make_host_mesh``
starts a world of one (NCCL on ``cuda``, gloo on ``cpu``) from a
``FileStore``, with no port, and lays it out as a (1, 1) mesh with the
production axis names.
"""
from __future__ import annotations

import os
import tempfile

from repro_torch import resolve_device

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data sheet
# (dense rates, no sparsity); the roofline's and chip_smoke.py's bounds
PEAK_FLOPS_BF16 = 989e12          # bf16 tensor cores, dense
PEAK_FLOPS_TF32 = 495e12          # TF32 tensor cores, dense
PEAK_FLOPS_F32 = 67e12            # f32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s of HBM3
# NVLink 4 within an 8-GPU HGX node: 900 GB/s per GPU in both directions
# together, 450e9 each way (data sheet)
NVLINK_BW = 450e9
# between nodes, one 400 Gb/s NDR InfiniBand adapter per GPU (the DGX H100
# layout): 50e9 bytes/s each way
IB_BW = 50e9
GPUS_PER_NODE = 8
CHIP_HBM_BYTES = 80 * 10**9       # the data sheet's 80 GB


def collective_link(group_size: int):
    """(name, bytes/s each way per GPU) of the link a collective over
    ``group_size`` ranks is bound by: NVLink within a node, InfiniBand once
    the group spans nodes (an axis of 16 ranks does)."""
    if group_size <= GPUS_PER_NODE:
        return "nvlink", NVLINK_BW
    return "infiniband", IB_BW


def hbm_bytes(device=None) -> int:
    """The card's memory (``total_memory``) on a CUDA device, else the
    data sheet's 80 GB (the dry run)."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return CHIP_HBM_BYTES


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod", over the
    current process group (which must hold 256 or 512 ranks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {n} ranks")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(device=None):
    """A (1, 1) ("data", "model") mesh over a world of one, started here
    (NCCL on ``cuda``, the default; gloo on ``cpu``) unless a group of one
    is already up.  The caller ends it with
    ``torch.distributed.destroy_process_group()``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":      # before the mesh, for NCCL
            torch.cuda.set_device(torch.cuda.current_device()
                                  if dev.index is None else dev)
        fd, path = tempfile.mkstemp(prefix="repro_torch_store_")
        os.close(fd)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(path, 1), rank=0,
                                world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError("the host mesh needs a world of one rank")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
