"""The table of peaks that every roofline share and ``mfu`` metric is
held to: published data-sheet rates, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet (dense, without sparsity): 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM3, at the card's full
700 W (the numbers ``chip_smoke.py`` used at commit 2bec3df). A card set
below 700 W reaches less; the benchmark prints the limit beside every
result.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_ops_per_s=67e12, bytes_per_s=3.35e12),
}


def peak(kind: str) -> dict:
    """The peaks of the card named ``kind``; a card not in the table has
    no roofline here, and raises."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r} in "
                       f"rtbench/roofline/peaks.py")
    return PEAKS[kind]


def bound_s(kind: str, ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 rate and the bytes over the memory rate."""
    p = peak(kind)
    return max(ops / p["f32_ops_per_s"], nbytes / p["bytes_per_s"])


def share_percent(kind: str, ops: float, nbytes: float,
                  seconds: float) -> float | None:
    """The bound as a percentage of ``seconds`` (a kernel's summed device
    time); None where nothing ran, never 0 for a share not measured."""
    if seconds <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * bound_s(kind, ops, nbytes) / seconds
