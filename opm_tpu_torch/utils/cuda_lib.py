"""Build and load the port's hand-written CUDA kernels and its host C++.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
for Hopper (``sm_90a``) into ``build/opm_tpu_torch/lib<name>.so`` at the
repository root on first use, then loaded with ctypes. A ``csrc/<name>.cpp``
(host code: the corner-point connection builder) is compiled the same way
by the host C++ compiler. Nothing is built when a module is imported: the
CPU path never builds a CUDA source. There is no fallback: a missing
compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "opm_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # products and sums round separately, as the plain PyTorch
              # version's elementwise operations do
              "--fmad=false",
              # each kernel's registers, shared memory and spills, kept in
              # build_log
              "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_libs: dict = {}
_lock = threading.Lock()
# the compiler's messages of each source built by this process
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _cxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) found")
    return path


def _paths(name: str):
    """(source, library) of csrc/<name>.cu, else csrc/<name>.cpp."""
    src = os.path.join(CSRC, name + ".cu")
    if not os.path.exists(src):
        src = os.path.join(CSRC, name + ".cpp")
    return src, os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(src: str, out: str) -> bool:
    """The library is newer than its source and every shared header."""
    if not os.path.exists(out):
        return False
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return os.path.getmtime(out) >= max(os.path.getmtime(d) for d in deps)


def build_all(names) -> list:
    """Compile the named sources (csrc/<name>.cu or .cpp) that have no
    up-to-date library, one compiler process each, all started together;
    returns the library paths."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        src, out = _paths(name)
        if _fresh(src, out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ([_nvcc(), *NVCC_FLAGS] if src.endswith(".cu")
               else [_cxx(), *HOST_FLAGS])
        proc = subprocess.Popen(cmd + ["-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, out, tmp, proc, cmd[0]))
    errors = []
    for src, out, tmp, proc, compiler in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{compiler} failed for {src}:\n{err}")
        else:
            build_log[os.path.basename(src)] = err
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_paths(name)[1] for name in names]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so; ``signatures`` maps each C
    entry to (argtypes) or (argtypes, restype); the default restype is int
    (a kernel entry's cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[0])
            for fn, sig in signatures.items():
                argtypes, restype = (sig if isinstance(sig, tuple)
                                     else (sig, ctypes.c_int))
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError_t {err})")


def dispatch(x, cuda_fn, plain_fn, *args, what: str, **kw):
    """The kernel on a CUDA tensor x, the plain version on a CPU tensor
    (both called with args and kw); any other device raises (there is no
    fallback between the two)."""
    if x.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if x.device.type == "cpu":
        return plain_fn(*args, **kw)
    raise RuntimeError(f"no {what} kernel for device {x.device}")


def batched(arg, dim, B):
    """A vmap rule's input with its batch axis first (expanded to B when
    the input is not batched)."""
    return arg.movedim(dim, 0) if dim is not None else \
        arg.expand(B, *arg.shape)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
D = ctypes.c_double
