"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
for Hopper (``sm_90a``) into ``build/opm_tpu_torch/lib<name>.so`` at the
repository root on first use, then loaded with ctypes. Nothing is built
when a module is imported: the CPU path never calls this. There is no
fallback: a missing compiler or a failed build raises.
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
              "--fmad=false"]

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    the library path."""
    src = os.path.join(CSRC, name + ".cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so; ``signatures`` maps each C
    entry to its argtypes (every entry returns a cudaError_t as int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError_t {err})")


def dispatch(x, cuda_fn, plain_fn, *args, what: str):
    """The kernel on a CUDA tensor x, the plain version on a CPU tensor;
    any other device raises (there is no fallback between the two)."""
    if x.device.type == "cuda":
        return cuda_fn(*args)
    if x.device.type == "cpu":
        return plain_fn(*args)
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
