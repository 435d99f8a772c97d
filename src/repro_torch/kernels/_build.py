"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Every ``repro_torch/csrc/<name>.cu`` becomes its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

A ``csrc/<name>.cpp`` is a kernel's host side where the host path is the
kernel's cost (``launch_host.cpp``): the host C++ compiler builds
it against PyTorch's headers and libraries into the Python module
``<name>``, and ``load_module`` imports it.

All sources build together, one compiler process each, into
``<repo>/build/repro_torch/<hash>/``, where the hash covers every source,
every shared header (``csrc/*.cuh``, which the ``.cu`` files include) and
the flags; a tree that was already built for the same sources is
reused.  Each library's compiler output (registers, shared memory,
spills) is kept beside it as ``lib<name>.log``.  Nothing builds at import:
the first CUDA launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_modules: Dict[str, ModuleType] = {}

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


def _host_cmd(src: Path, out: Path) -> List[str]:
    """The host compiler's command for a module against this PyTorch."""
    import torch
    from torch.utils import cpp_extension
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) found")
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    includes = [*cpp_extension.include_paths(),
                sysconfig.get_paths()["include"]]
    libs = cpp_extension.library_paths()
    return [cxx, "-O2", "-std=c++17", "-w", "-shared", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            *(f"-I{p}" for p in includes), "-o", str(out), str(src),
            *(f"-L{p}" for p in libs), *(f"-Wl,-rpath,{p}" for p in libs),
            "-lc10", "-ltorch_cpu", "-ltorch_python"]


def _module_file(name: str) -> str:
    return name + sysconfig.get_config_var("EXT_SUFFIX")


def _sources():
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")])


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in CSRC.glob("*.cpp"):
        h.update(" ".join(_host_cmd(src, Path("out"))).encode())
    for src in [*_sources(), *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source not yet built for this hash; returns the
    directory.  Raises with the compiler output if any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in _sources():
        cuda = src.suffix == ".cu"
        so = out / (f"lib{src.stem}.so" if cuda else _module_file(src.stem))
        if so.exists():
            continue
        tmp = out / f"{so.name}.{os.getpid()}.tmp"
        cmd = ([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)] if cuda
               else _host_cmd(src, tmp))
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
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
        raise RuntimeError("a kernel build failed:\n" + "\n".join(failed))
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


def load_module(name: str) -> ModuleType:
    """The Python module built from ``csrc/<name>.cpp`` (building all
    kernels on first use)."""
    with _lock:
        mod = _modules.get(name)
        if mod is None:
            path = build_all() / _module_file(name)
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _modules[name] = mod
        return mod
