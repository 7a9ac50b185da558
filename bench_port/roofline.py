"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes of the port's kernels computed from their shapes.

The nnz and byte counts are those of ``lobpcg_tpu_torch/bench.py``
(``measure_spmm``), frozen here so that the program cannot move them.
"""

from __future__ import annotations

import subprocess

# Published device-memory rates (bytes/s), matched in order against the
# card's name: NVIDIA's data sheets (H100 SXM 3.35 TB/s at 700 W).
HBM_BYTES_PER_S = (
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
    ("H200", 4.8e12),
)


def hbm_bytes_per_s(device_name: str):
    """The published memory rate of a card, None for a card not listed."""
    return next((bw for key, bw in HBM_BYTES_PER_S if key in device_name),
                None)


def stencil_nnz(n: int, segments: int) -> int:
    """Stored entries of a segmented tridiagonal operator (a diagonal
    added to it falls on its diagonal): 3 m - 2 a segment of m rows."""
    m = n // segments
    return segments * (3 * m - 2)


def stencil_diag_bytes(n: int, k: int, itemsize: int = 4) -> int:
    """Least bytes of one A y = S(y) + d * y over [n, k]: X read once, Y
    written once, the diagonal d read once."""
    return 2 * n * k * itemsize + n * itemsize


def power_limit(index: int = 0):
    """The card's power limit as nvidia-smi reports it (None where
    nvidia-smi cannot say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
