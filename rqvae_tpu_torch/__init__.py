"""PyTorch + CUDA port of ``rqvae_tpu`` for one NVIDIA H100 (sm_90a).

Mirrors ``rqvae_tpu``'s module paths and function names so every function
has an obvious counterpart; the JAX package stays the numerical reference.

Parameters are plain nested dicts / lists of tensors with exactly the JAX
pytree layout (weights stored (in, out), forward ``x @ w``), so parameters
made by ``rqvae_tpu`` load through ``models.convert`` unchanged.

The TPU's Pallas kernels on the ported paths (serving, and the decoder
train step with its flash attention) are hand-written CUDA C++ (``csrc/``),
built with nvcc at first use and loaded through ctypes
(``ops/_cuda_build.py``). Every kernel wrapper runs its plain PyTorch twin
for CPU tensors only; on a CUDA tensor it launches the kernel or raises.

Entry points that create tensors (``init`` functions, ``convert``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU they raise.
"""

__version__ = "0.1.0"
