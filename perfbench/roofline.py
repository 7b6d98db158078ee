"""The byte count behind every roofline share, and the card's peak.

One rule, whatever kernel does the work: the operator's values inside the
matrix once at f32, and each vector the work reads once and each it writes
once. Indices, padding and transpose copies are layout and are not
counted, so a staged pair, a one-pass pair, a CUDA graph or a new
megakernel are held to the same count. It is a lower bound that no sound
implementation passes.

Worked values (PERF.md): the band pair at 2^23 x 11 moves 369 + 134 MB
(0.1502 ms at 3.35 TB/s), the WCOO pair at 2^21 x 2048 41.9 + 16.8 MB
(0.0175 ms), a band LSQR iteration 369 + 268 MB (0.190 ms).
"""

from __future__ import annotations

#: NVIDIA H100 SXM, HBM3, data sheet: 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
#: f32 bytes an element, the precision every configuration states
F32 = 4

#: (m-vector passes, n-vector passes) of one unit of work: a pair reads
#: and writes u (m) and reads v and writes z (n); an LSQR iteration reads
#: and writes u (m) and v, w, x (n)
VECTOR_PASSES = {"pair": (2, 2), "lsqr_iteration": (2, 6)}


def work_bytes(values_inside: int, m: int, n: int, work: str) -> int:
    """Least bytes that one ``work`` ("pair" or "lsqr_iteration") moves on
    an m x n operator with ``values_inside`` stored values."""
    pm, pn = VECTOR_PASSES[work]
    return (int(values_inside) + pm * int(m) + pn * int(n)) * F32


def bound_seconds(nbytes: int) -> float:
    """The least time those bytes take at the card's peak rate."""
    return nbytes / HBM_BYTES_PER_S


def share_percent(nbytes: int, seconds: float) -> float:
    """The roofline share, in %, of work that took ``seconds`` on the card."""
    return 100.0 * bound_seconds(nbytes) / seconds
