"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Every ``repro_torch/csrc/<name>.cu`` becomes its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

All sources build together, one ``nvcc`` each, into
``<repo>/build/repro_torch/<hash>/``, where the hash covers every source
and the flags; a tree that was already built for the same sources is
reused.  Each library's compiler output (registers, shared memory,
spills) is kept beside it as ``lib<name>.log``.  Nothing builds at import:
the first CUDA launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit to build")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source not yet built for this hash; returns the
    directory.  Raises with the compiler output if any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        so = out / f"lib{src.stem}.so"
        if so.exists():
            continue
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        (out / f"lib{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            # atomic, so concurrent builders agree on the library
            # lint: allow[durability-ordering] build cache: a lost rename only costs a rebuild
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` (building all kernels on first use),
    with each function's ``(restype, argtypes)`` set from ``signatures``.
    Pointers and the stream are ``c_void_p``: a plain int would be cut to
    32 bits."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _libs[name] = lib
        return lib
