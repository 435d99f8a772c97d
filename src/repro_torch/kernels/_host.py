"""The C++ host module ``csrc/launch_host.cpp``, bound once to the CUDA
launchers of ``csrc/embedding_bag.cu``, ``csrc/tracker_select.cu`` and
``csrc/ssu_dedupe.cu``: the checks, allocations and launch of a call to
those kernels run there, so a call's host path costs a few field reads,
not Python's attribute calls."""
from __future__ import annotations

import ctypes

from repro_torch.kernels import _build

_LAUNCHERS = (("embedding_bag", "embedding_bags_fwd_launch"),
              ("embedding_bag", "embedding_bags_bwd_launch"),
              ("tracker_select", "tracker_select_scratch_words"),
              ("tracker_select", "tracker_select"),
              ("ssu_dedupe", "ssu_scratch_words"),
              ("ssu_dedupe", "ssu_dedupe_evict"))

_bound = None


def module():
    """The bound module (building all kernels on first use)."""
    global _bound
    if _bound is None:
        host = _build.load_module("launch_host")
        host.bind(*(ctypes.cast(getattr(_build.load(lib, {}), fn),
                                ctypes.c_void_p).value
                    for lib, fn in _LAUNCHERS))
        _bound = host
    return _bound
