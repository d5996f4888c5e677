"""The least time the card could take for a window's work.

Peaks of one NVIDIA H100 SXM at its 700 W limit: HBM3 bandwidth 3.35 TB/s
(NVIDIA's data sheet); INT32 operations outside the tensor cores 16.75
TOP/s, derived and not published: 64 INT32 lanes per SM against 128 FP32
lanes, so a quarter of the data sheet's 67 TFLOP/s FP32 rate, which counts
an FMA as two operations. A window's bound is the larger of its bytes over
the first and its operations over the second.

Bytes count each input byte read once and each output byte written once,
for the units the window holds (not the padding of its bucket).
Operations count 75 integer operations per threefry lane that deciding a
unit needs (``reference.draws.lanes_to_decide``): 20 rounds of add,
rotate and xor, 5 key injections of two adds, the second word's first
add, the counter's shift and or, and the draw's shift and compare. The
parts of the key schedule that every lane of a unit shares are left out.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import draws as ref

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4
OPS_PER_LANE = 20 * 3 + 5 * 2 + 1 + 2 + 2


def _bounds(nbytes: np.ndarray, lanes: np.ndarray) -> float:
    """Sum over windows of max(bytes / bandwidth, ops / int32 rate)."""
    return float(np.maximum(nbytes / PEAK_BYTES_PER_S,
                            lanes * OPS_PER_LANE / PEAK_INT32_OPS_PER_S).sum())


def _per_window(sim, windows) -> tuple:
    """(units a window, decision lanes a window) of ``windows``, each
    (uid_lo, uid_hi, npkts, thresh, ...)."""
    sizes = np.array([len(w[0]) for w in windows], np.int64)
    parts = [np.concatenate([w[c] for w in windows]) for c in range(4)]
    lanes = ref.lanes_to_decide(sim.seed, *parts, sim.width)
    ends = np.cumsum(sizes)
    cum = np.concatenate([[0], np.cumsum(lanes)])
    return sizes, cum[ends] - cum[ends - sizes]


def draw_flags_bound(sims) -> tuple:
    """(summed bound in s, card windows) of the draw_flags windows: each
    reads 4 uint32 words a unit and writes one flag bit a unit."""
    total, count = 0.0, 0
    for sim in sims:
        card = [d for d in sim.draws if d[5]]
        if not card:
            continue
        sizes, lanes = _per_window(sim, card)
        total += _bounds(16 * sizes + (sizes + 7) // 8, lanes)
        count += len(card)
    return total, count
