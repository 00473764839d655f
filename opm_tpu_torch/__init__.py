"""opm_tpu_torch: the PyTorch/CUDA port of opm_tpu for one NVIDIA H100.

Pure PyTorch on tensors (float64 throughout, an explicit ``device``
argument everywhere, no global default dtype or device), with hand-written
Hopper kernels for the hot loops of the main path, all CUDA C++ in
``csrc/`` (built with nvcc at first use on the card, loaded with ctypes;
no Triton). Each kernel has a plain PyTorch twin in the module that
launches it; the twin runs for CPU tensors and is the kernel's oracle on
the card. The package imports neither jax nor opm_tpu.
"""

__version__ = "0.1.0"
