"""Streaming copy of an [n, k] f32 block: the hand-written CUDA kernel
``csrc/copy.cu`` and its plain PyTorch version.

Port of the TPU kernel ``bench.py:_copy_fn``, the double-buffered
HBM -> VMEM -> HBM copy that measures the attainable memory rate under
the SpMM headline (``lobpcg_tpu_torch/bench.py``).  It reads and writes
every element once: 2 * n * k * 4 bytes.  Unlike the TPU kernel, which
copied whole 2048-row tiles only, it copies every row.

``stream_copy`` launches the kernel for a CUDA tensor and runs the plain
version ``stream_copy_reference`` only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lobpcg_tpu_torch.ops.cuda.build import build_record, check, load_library

# The C entry point of csrc/copy.cu and its argument types (it returns an
# int cudaError_t).
SIGNATURES = {
    "lobpcg_copy_f32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_void_p],
}


@functools.cache
def _lib():
    """The built library with its entry point's ctypes signature."""
    return load_library("copy", SIGNATURES)


def build() -> dict:
    """Build and load the kernel library now; returns the build record."""
    _lib()
    return build_record("copy")


def _check_args(X):
    if X.dim() != 2:
        raise ValueError(f"stream_copy: X must be [n, k], got {tuple(X.shape)}")
    if X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"stream_copy: empty block {tuple(X.shape)}")


def stream_copy_reference(X: torch.Tensor) -> torch.Tensor:
    """Plain version: a new block equal to X."""
    _check_args(X)
    return X.clone()


def stream_copy(X: torch.Tensor) -> torch.Tensor:
    """A new [n, k] block equal to X.

    CUDA tensor: launches ``csrc/copy.cu`` on the current stream (f32,
    contiguous, any base address), without synchronising, and counts the
    launch in ``stream_copy.launches``; anything the kernel does not take
    raises.  CPU tensor: the plain version.
    """
    _check_args(X)
    if X.device.type == "cpu":
        return stream_copy_reference(X)
    if X.device.type != "cuda":
        raise ValueError(f"stream_copy: unsupported device {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"stream_copy: kernel takes f32, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("stream_copy: X must be contiguous")
    lib = _lib()
    Y = torch.empty_like(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lobpcg_copy_f32(X.data_ptr(), Y.data_ptr(), X.numel(), stream)
    stream_copy.launches += 1
    check(lib, code, "copy launch")
    return Y


stream_copy.launches = 0
