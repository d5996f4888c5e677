"""Counter-based RNG: Threefry-2x32 (20 rounds), host twin and torch twin.

Packet-loss sampling must be a pure function of (seed, unit id, packet
lane) so that the numpy host twin, the CUDA kernels and any batching of the
draws produce identical drops (SURVEY.md §7 "Determinism across backends").
This is the Threefry-2x32-20 function of Salmon et al., "Parallel Random
Numbers: As Easy as 1, 2, 3" (SC'11), bit for bit the generator of
``shadow_tpu/ops/prng.py``.

Three implementations of one function:

- ``threefry2x32``: numpy, uint32 wraparound (the host twin that
  network/fluid.py::loss_flags uses);
- ``threefry2x32_torch``: plain PyTorch. torch has no ``+``, ``<<``, ``>>``,
  ``<`` or ``min`` on ``torch.uint32`` on the CPU (only ``^`` and casts), so
  it computes in ``int64`` holding values in [0, 2**32), masking after
  every add and shift;
- ``threefry2x32`` in ``csrc/draw.cu``: the ``__device__`` function inside
  the draw kernels.

Loss decisions avoid floats entirely: a unit is dropped iff
``draw_24bit < floor(loss * 2**24)`` with the threshold precomputed
host-side (see quantize_loss); integer compares are bit-identical
everywhere.
"""

from __future__ import annotations

import numpy as np

ROT_A = (13, 15, 26, 6)
ROT_B = (17, 29, 16, 24)
PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, in numpy. All args uint32 arrays (or
    scalars); returns (x0, x1) uint32."""
    u32 = np.uint32

    def as_u32(v):
        return np.asarray(v, dtype=np.uint32)

    def cast(v):
        # uint32-op-uint32 already yields uint32: skip the copying astype
        return v if getattr(v, "dtype", None) == np.uint32 \
            else v.astype(np.uint32)

    k0, k1, c0, c1 = as_u32(k0), as_u32(k1), as_u32(c0), as_u32(c1)
    ks = (k0, k1, k0 ^ k1 ^ u32(PARITY))

    def rotl(x, r):
        return cast((x << u32(r)) | (x >> u32(32 - r)))

    # uint32 wraparound is intended; numpy warns on scalar overflow only
    with np.errstate(over="ignore"):
        x0 = cast(c0 + ks[0])
        x1 = cast(c1 + ks[1])
        for group in range(5):
            for r in (ROT_A if group % 2 == 0 else ROT_B):
                x0 = cast(x0 + x1)
                x1 = rotl(x1, r)
                x1 = x0 ^ x1
            j = group + 1
            x0 = cast(x0 + ks[j % 3])
            x1 = cast(x1 + ks[(j + 1) % 3] + u32(j))
    return x0, x1


def threefry2x32_torch(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, in plain PyTorch. Arguments are ``int64``
    tensors (or Python ints) holding values in [0, 2**32); returns
    ``(x0, x1)`` as ``int64`` tensors in the same range. Runs on whatever
    device its tensors live on."""
    k2 = (k0 ^ k1 ^ PARITY) & _M32
    ks = (k0, k1, k2)

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & _M32

    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for group in range(5):
        for r in (ROT_A if group % 2 == 0 else ROT_B):
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        j = group + 1
        x0 = (x0 + ks[j % 3]) & _M32
        x1 = (x1 + ks[(j + 1) % 3] + j) & _M32
    return x0, x1


def quantize_loss(reliability: np.ndarray) -> np.ndarray:
    """Precompute integer drop thresholds from a float32 reliability matrix:
    drop iff draw_24bit < threshold, threshold = round((1-rel) * 2**24).

    Computed once, host-side, in float64 for exactness; the per-unit compare
    is pure integer on every backend."""
    loss = 1.0 - reliability.astype(np.float64)
    thresh = np.rint(loss * float(1 << 24)).astype(np.int64)
    return np.clip(thresh, 0, 1 << 24).astype(np.uint32)
