"""All-pairs shortest path on the device: min-plus repeated squaring.

The port of shadow_tpu/ops/apsp.py. ``apsp_device`` keeps the reference's
contract: a (G, G) int64 one-hop latency table with INF_I64 sentinels and a
0 diagonal, and a float32 one-hop reliability table, in; the same two
tables for shortest-latency paths out (int64 with INF_I64 where
unreachable, float32 reliability carried along the chosen decomposition).
It runs ceil(log2 G) min-plus squarings over int32 latencies saturated at
INF_I32, each picking, per (i, j), the FIRST k with the least
``min(lat[i,k] + lat[k,j], INF_I32)`` and carrying
``rel[i,k*] * rel[k*,j]``. For reachable pairs the result equals
network/graph.py::_apsp_minplus (int32 saturation only affects candidates
that lose the argmin).

Two versions compute the same tables bit for bit:

- the plain PyTorch version (``squarings_plain``), blocked over rows so
  memory stays about ``block * G * G * 4`` bytes;
- the CUDA kernel ``apsp_square_kernel`` (csrc/apsp.cu; replaces the
  reference's ``_apsp_kernel``, apsp.py:30), one launch per squaring with
  ping-pong buffers, behind the wrapper ``squarings``: a CPU tensor runs
  the plain version, a CUDA tensor launches the kernel or raises.
  ``LAUNCHES`` counts kernel launches (one per squaring).

The reference pads G up to a multiple of ``block`` with unreachable rows
(INF latency, 0 reliability, identity diagonal). A padded k never wins an
argmin for a real pair: its candidate is INF + INF, and where every real
candidate is INF too, the first minimum is k = 0. So neither version pads;
``block`` only sets the plain version's rows per step, as it sets the
reference's.

Float32 products follow the reference's XLA CPU program, which runs with
denormals flushed: an operand below 2**-126 counts as zero, and a product
that is below 2**-126 after rounding to float32's 24 bits (with an
unbounded exponent) becomes a zero of its sign. Both versions compute that
explicitly (``_ftz_mul``; the kernel's ``ftz_mul``), from the exact product
in float64, so neither depends on a device's flush mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shadow_tpu_torch.network.graph import INF_I32, INF_I64
from shadow_tpu_torch.ops import devcfg

#: smallest normal float32 (2**-126): below it XLA's CPU flush counts zero
FLT_MIN = 2.0 ** -126

#: kernel launches since the last reset_launches() (one per squaring);
#: only CUDA launches count
LAUNCHES = {"apsp": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def squaring_steps(g: int) -> int:
    """ceil(log2 G) squarings, at least one (the reference's count)."""
    return max(1, int(math.ceil(math.log2(max(g, 2)))))


def _ftz_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a * b with denormal operands counted as zero and a product
    that is tiny after rounding flushed to a signed zero."""
    a = torch.where(a.abs() < FLT_MIN, torch.zeros_like(a), a)
    b = torch.where(b.abs() < FLT_MIN, torch.zeros_like(b), b)
    p = a.double() * b.double()  # exact: 24 + 24 bits fit 53
    # the product rounded to 24 bits with an unbounded exponent, scaled
    # into the normal range: tiny after rounding iff below 2**-62 there
    tiny = (p * 2.0 ** 64).float().abs() < 2.0 ** -62
    return torch.where(tiny, torch.copysign(torch.zeros_like(p), p),
                       p).float()


def square_plain(lat: torch.Tensor, rel: torch.Tensor,
                 block: int = 16) -> tuple:
    """One min-plus squaring of (G, G) int32 ``lat`` / float32 ``rel``,
    ``block`` rows at a time."""
    g = lat.shape[0]
    new_lat = torch.empty_like(lat)
    new_rel = torch.empty_like(rel)
    for i0 in range(0, g, block):
        i1 = min(g, i0 + block)
        # cand[i, k, j] = lat[i, k] + lat[k, j] (two INF_I32 fit int32)
        cand = lat[i0:i1, :, None] + lat[None, :, :]
        cand = torch.clamp_max(cand, int(INF_I32))
        k_star = torch.argmin(cand, dim=1)  # (b, G): the first minimum
        new_lat[i0:i1] = cand.gather(1, k_star[:, None, :])[:, 0, :]
        new_rel[i0:i1] = _ftz_mul(rel[i0:i1].gather(1, k_star),
                                  rel.gather(0, k_star))
    return new_lat, new_rel


def squarings_plain(lat: torch.Tensor, rel: torch.Tensor, steps: int,
                    block: int = 16) -> tuple:
    """``steps`` squarings with the plain version."""
    for _ in range(steps):
        lat, rel = square_plain(lat, rel, block)
    return lat, rel


def _check(lat: torch.Tensor, rel: torch.Tensor) -> None:
    if lat.dtype != torch.int32 or rel.dtype != torch.float32:
        raise TypeError(f"apsp: want int32 latency and float32 "
                        f"reliability, got {lat.dtype} and {rel.dtype}")
    if lat.dim() != 2 or lat.shape[0] != lat.shape[1] \
            or rel.shape != lat.shape:
        raise ValueError(f"apsp: want two (G, G) tables, got "
                         f"{tuple(lat.shape)} and {tuple(rel.shape)}")
    if lat.device != rel.device:
        raise ValueError(f"apsp: tables on {lat.device} and {rel.device}")
    if lat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"apsp: unsupported device {lat.device}")
    if not (lat.is_contiguous() and rel.is_contiguous()):
        raise ValueError("apsp: tables must be contiguous")
    if lat.shape[0] < 1 or lat.shape[0] >= 1 << 15:
        raise ValueError(f"apsp: G={lat.shape[0]} outside [1, 32768) "
                         f"(the kernel indexes G*G in 32 bits)")


def squarings(lat: torch.Tensor, rel: torch.Tensor, steps: int,
              block: int = 16) -> tuple:
    """``steps`` min-plus squarings of (G, G) int32 ``lat`` (values in
    [0, INF_I32]) and float32 ``rel``. CPU tensors: the plain version. CUDA
    tensors: one kernel launch per squaring on the current stream,
    ping-ponging between two buffer pairs, or an exception."""
    _check(lat, rel)
    if lat.device.type == "cpu":
        return squarings_plain(lat, rel, steps, block)
    lib = devcfg.kernel_lib("apsp")
    g = lat.shape[0]
    stream = torch.cuda.current_stream(lat.device).cuda_stream
    src = (lat, rel)
    bufs = [(torch.empty_like(lat), torch.empty_like(rel)) for _ in
            range(min(steps, 2))]
    for s in range(steps):
        dst = bufs[s % 2]
        with devcfg.current(lat.device):  # the stream's card, as CUDA needs
            code = lib.shadow_apsp_square(
                src[0].data_ptr(), src[1].data_ptr(), g,
                dst[0].data_ptr(), dst[1].data_ptr(), stream)
        devcfg.check_launch(lib, code, "apsp")
        LAUNCHES["apsp"] += 1
        src = dst
    return src


def apsp_device(latency_ns: np.ndarray, reliability: np.ndarray,
                block: int = 16, device: str = "cuda") -> tuple:
    """Device APSP. Input: (G, G) int64 one-hop latency with INF_I64
    sentinels and 0 diagonal, float32 one-hop reliability with 1.0
    diagonal. Output in the same convention (int64 with INF_I64 where
    unreachable). ``device`` is ``cuda`` (the kernel) or ``cpu`` (the
    plain version).

    Requires every finite edge latency < INF_I32 (~1.07 s) — validated.
    """
    g = latency_ns.shape[0]
    finite = latency_ns[latency_ns < INF_I64]
    if finite.size and finite.max() >= int(INF_I32):
        raise ValueError("edge latency >= ~1.07s: device APSP unsupported")
    dev = devcfg.select_device(device)
    lat32 = np.minimum(latency_ns, np.int64(INF_I32)).astype(np.int32)
    rel32 = np.ascontiguousarray(reliability, dtype=np.float32)
    out_lat, out_rel = squarings(
        torch.from_numpy(lat32).to(dev), torch.from_numpy(rel32).to(dev),
        squaring_steps(g), block)
    out_lat = out_lat.cpu().numpy().astype(np.int64)
    out_rel = out_rel.cpu().numpy()
    out_lat[out_lat >= int(INF_I32)] = INF_I64
    return out_lat, out_rel
