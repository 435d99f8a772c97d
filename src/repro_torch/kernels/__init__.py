"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` is the dispatch: a CUDA tensor goes to the kernel, a CPU tensor to
the plain version in ``ref`` (the role ``repro.kernels.ops._interpret``
plays in the reference).  There is no fallback: a kernel that fails to
build or launch raises.

``LAUNCHES`` counts each wrapper's kernel launches (plain integers, one
per wrapper call that launched), so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import torch

LAUNCHES = {"embedding_bag": 0, "embedding_bag_backward": 0,
            "tracker_select": 0, "ssu_dedupe_evict": 0, "row_hash": 0,
            "flash_attention": 0, "flash_attention_backward": 0,
            "rglru_scan": 0, "rglru_scan_backward": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the same CUDA device (launch the
    kernel), False when all lie on the CPU (run the plain version).
    Mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {devices}")
    (dev,) = devices
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def require(cond: bool, what: str) -> None:
    """Argument check of a kernel wrapper: raise instead of launching."""
    if not cond:
        raise ValueError(what)


def check_launch(rc: int, name: str) -> None:
    """Raise if the C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"code {rc}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch_on(dev: int, fn, *args):
    """``fn(*args)`` with CUDA device ``dev`` current (a host module's
    launcher runs on the current device)."""
    if dev == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)
