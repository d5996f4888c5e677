"""Batched integer kernels for the device-resident columnar transport.

The port of shadow_tpu/ops/transport_kernels.py. One clean cumulative-ack
advance per endpoint row (NewReno and CUBIC window arithmetic in int64, a
21-step binary-search cube root, CUBIC epoch adoption), in three
versions that compute the same integers:

- the numpy host version (``icbrt``, ``cc_on_ack``, ``ack_advance``,
  ``rto_min_scan``), which serves cohorts below the device floor
  (network/devtransport.py), as in the reference;
- the plain PyTorch version (``icbrt_torch``, ``cc_on_ack_torch``,
  ``ack_advance_torch``) on int64 tensors; torch's ``//`` floors, as
  Python's and numpy's do;
- the CUDA kernel ``ack_advance_kernel`` (csrc/transport.cu; replaces the
  jax.jit program of the reference's ``DeviceAckKernel._fn``), behind the
  wrapper ``ack_advance_device``: a CPU tensor runs the plain version, a
  CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
  launches (plain runs are not launches).

``DeviceAckKernel`` replaces the reference's class of the same name. A
cohort lives in an ``AckSlot``: a (9, P) int64 input and a (5, P) output,
page-locked on a card, made once per bucket P (powers of two from 256, as
the reference's pinned bucket shapes) and reused, and one CUDA event. The
caller fills the first n input columns in place (network/devtransport.py's
gather writes each entry straight into them); the kernel reads them and
writes its result through the slot's device addresses, and the caller
reads the first n output columns after the event: one launch and one
event a cohort, no copy and no allocation once its bucket has a slot. The
reference also chunks cohorts above its top bucket, only so that XLA
compiles a handful of programs; the kernel takes any row count, so the
buckets simply go on doubling. Rows are independent and only the first n
are read, so neither the padding nor a slot's earlier cohort can change a
result.

Bit-exactness (why int64 arrays equal the scalar Python twin,
network/transport.py): every operand stays below 2**63 under the
transport's documented clamps (cwnd <= 2**45, newly <= 2**20 in cubic,
|d| <= 2e5, w_max capped at 2**32 before the cube root), and floor
division on int64 equals Python's ``//``. The cube root is a
fixed-iteration binary search whose decisions equal transport._icbrt's
while-loop (once lo == hi the invariant lo**3 <= x makes further
iterations no-ops).

The constants below are deliberate copies of network/transport.py's:
a kernel is audited against the module it must agree with, so it does not
import its constants from it.
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.ops import devcfg

NS_PER_MS = 1_000_000
MSS = 1460
INIT_CWND = 10 * MSS
MIN_CWND = 2 * MSS

#: CongestionControl.cc_id dispatch values (transport.py registry twin)
CC_NEWRENO = 0
CC_CUBIC = 1

#: fixed iteration count for the vectorized cube root: ceil(log2(2**20))
#: + 1 covers transport._icbrt's full [0, 2**20] search interval
_ICBRT_ITERS = 21

#: the nine input columns of one cohort, in kernel order
IN_COLUMNS = ("cc_id", "cwnd", "ssthresh", "w_max", "epoch_start",
              "snd_una", "bytes_acked", "cum_ack", "now")
#: the five output columns
OUT_COLUMNS = ("snd_una", "bytes_acked", "cwnd", "w_max", "epoch_start")

#: kernel launches since the last reset_launches(); only CUDA launches
#: count
LAUNCHES = {"ack_advance": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- numpy host version ---------------------------------------------------------

def icbrt(x: np.ndarray) -> np.ndarray:
    """Vectorized floor integer cube root: the batch twin of
    transport._icbrt (same binary search over [0, 2**20], fixed-trip).
    ``x`` is a non-negative int64 array with values < 2**60."""
    lo = np.zeros_like(x)
    hi = np.full_like(x, 1 << 20)
    for _ in range(_ICBRT_ITERS):
        mid = (lo + hi + 1) >> 1
        ok = mid * mid * mid <= x
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid - 1)
    return lo


def cc_on_ack(cc_id, cwnd, ssthresh, w_max, epoch_start, newly, now):
    """Batched CongestionControl.on_ack over a cohort of endpoints: the
    columnar twin of NewReno.on_ack and CubicLike.on_ack dispatched on the
    ``cc_id`` column. All inputs are int64 arrays of one cohort length;
    returns (cwnd', w_max', epoch_start'). ssthresh is read-only here
    (neither algorithm moves it on an ack) and passed for the slow-start
    test. Each step mirrors one line of the scalar twins."""
    ss = cwnd < ssthresh
    # slow start, shared shape: cwnd += min(newly, cwnd)
    cwnd_ss = cwnd + np.minimum(newly, cwnd)
    # NewReno congestion avoidance: cwnd += max(1, MSS * newly // cwnd)
    cwnd_nr = cwnd + np.maximum(1, MSS * newly // cwnd)
    # CubicLike congestion avoidance (the first CA ack with no recorded
    # epoch adopts (now, cwnd) as the epoch)
    es0 = epoch_start == 0
    eps = np.where(es0, now, epoch_start)
    wmax = np.where(es0, cwnd, w_max)
    t_ms = (now - eps) // NS_PER_MS
    wmax_c = np.minimum(wmax, 1 << 32)
    k_ms = icbrt((wmax_c * 3 // (4 * MSS)) * 1_000_000_000)
    d = np.clip(t_ms - k_ms, -200_000, 200_000)
    a = np.where(d < 0, -d, d)
    delta = (a * a * a // 1_000_000) * (4 * MSS) // 10_000
    target = np.clip(np.where(d < 0, wmax - delta, wmax + delta),
                     MIN_CWND, 1 << 45)
    nn = np.minimum(newly, 1 << 20)
    inc = np.minimum(target - cwnd, 1 << 40) * nn // cwnd
    below = np.minimum(cwnd + np.maximum(inc, 1), target)
    creep = cwnd + np.maximum(MSS * nn // (100 * cwnd), 1)
    cwnd_cu = np.where(cwnd < target, below, creep)

    cubic = cc_id == CC_CUBIC
    cwnd_out = np.where(ss, cwnd_ss, np.where(cubic, cwnd_cu, cwnd_nr))
    # cubic epoch adoption happens only on a cubic CA ack
    adopt = cubic & ~ss
    return (cwnd_out, np.where(adopt, wmax, w_max),
            np.where(adopt, eps, epoch_start))


def ack_advance(cc_id, cwnd, ssthresh, w_max, epoch_start, snd_una,
                bytes_acked, cum_ack, now):
    """One clean cumulative-ack advance for a cohort: the batched twin of
    StreamSender.on_ack's strict-advance arithmetic (scoreboards empty,
    not in recovery: network/devtransport.py verifies the preconditions
    row by row; rows that fail take the scalar twin).

    Returns (snd_una', bytes_acked', cwnd', w_max', epoch_start').
    dup_acks/rto_backoff/retries reset to (0, 1, 0) on every advance:
    constants, applied by the caller during writeback."""
    newly = cum_ack - snd_una
    cwnd2, w_max2, eps2 = cc_on_ack(cc_id, cwnd, ssthresh, w_max,
                                    epoch_start, newly, now)
    return cum_ack, bytes_acked + newly, cwnd2, w_max2, eps2


def rto_min_scan(deadline: np.ndarray) -> tuple:
    """Vectorized RTO expiry scan: (earliest deadline, its column index)
    over a cohort's armed-RTO deadline column (T_NEVER-filled when
    unarmed)."""
    i = int(np.argmin(deadline))
    return int(deadline[i]), i


# -- plain PyTorch version --------------------------------------------------

def icbrt_torch(x: torch.Tensor) -> torch.Tensor:
    """icbrt on an int64 tensor."""
    lo = torch.zeros_like(x)
    hi = torch.full_like(x, 1 << 20)
    for _ in range(_ICBRT_ITERS):
        mid = (lo + hi + 1) >> 1
        ok = mid * mid * mid <= x
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return lo


def cc_on_ack_torch(cc_id, cwnd, ssthresh, w_max, epoch_start, newly, now):
    """cc_on_ack on int64 tensors, step for step."""
    ss = cwnd < ssthresh
    cwnd_ss = cwnd + torch.minimum(newly, cwnd)
    cwnd_nr = cwnd + torch.clamp(MSS * newly // cwnd, min=1)
    es0 = epoch_start == 0
    eps = torch.where(es0, now, epoch_start)
    wmax = torch.where(es0, cwnd, w_max)
    t_ms = (now - eps) // NS_PER_MS
    wmax_c = torch.clamp(wmax, max=1 << 32)
    k_ms = icbrt_torch((wmax_c * 3 // (4 * MSS)) * 1_000_000_000)
    d = torch.clamp(t_ms - k_ms, -200_000, 200_000)
    a = d.abs()
    delta = (a * a * a // 1_000_000) * (4 * MSS) // 10_000
    target = torch.clamp(torch.where(d < 0, wmax - delta, wmax + delta),
                         MIN_CWND, 1 << 45)
    nn = torch.clamp(newly, max=1 << 20)
    inc = torch.clamp(target - cwnd, max=1 << 40) * nn // cwnd
    below = torch.minimum(cwnd + torch.clamp(inc, min=1), target)
    creep = cwnd + torch.clamp(MSS * nn // (100 * cwnd), min=1)
    cwnd_cu = torch.where(cwnd < target, below, creep)

    cubic = cc_id == CC_CUBIC
    cwnd_out = torch.where(ss, cwnd_ss, torch.where(cubic, cwnd_cu, cwnd_nr))
    adopt = cubic & ~ss
    return (cwnd_out, torch.where(adopt, wmax, w_max),
            torch.where(adopt, eps, epoch_start))


def ack_advance_torch(cc_id, cwnd, ssthresh, w_max, epoch_start, snd_una,
                      bytes_acked, cum_ack, now):
    """Plain version of the ack_advance kernel: ack_advance on nine int64
    tensors of one length; returns the five output tensors."""
    newly = cum_ack - snd_una
    cwnd2, w_max2, eps2 = cc_on_ack_torch(cc_id, cwnd, ssthresh, w_max,
                                          epoch_start, newly, now)
    return cum_ack, bytes_acked + newly, cwnd2, w_max2, eps2


# -- the kernel wrapper --------------------------------------------------------

#: the smallest slot bucket; buckets double from here (the reference pins
#: 256 ... 65,536 and chunks above; here they go on doubling)
MIN_BUCKET = 256


def bucket(n: int) -> int:
    """The slot width for a cohort of ``n`` rows: the least power of two
    at or above both ``n`` and MIN_BUCKET."""
    return max(MIN_BUCKET, 1 << max(n - 1, 0).bit_length())


def _launch(in_ptr: int, p: int, n: int, out_ptr: int, stream) -> None:
    """Queue ack_advance_kernel on the first ``n`` of ``p`` columns; the
    one place a launch is counted."""
    lib = devcfg.kernel_lib("transport")
    with devcfg.current(stream.device):  # the stream's card, as CUDA needs
        code = lib.shadow_ack_advance(in_ptr, p, n, out_ptr,
                                      stream.cuda_stream)
    devcfg.check_launch(lib, code, "ack_advance")
    LAUNCHES["ack_advance"] += 1


def ack_advance_device(packed: torch.Tensor) -> torch.Tensor:
    """One cohort's ack advance: (9, n) int64 rows in ``IN_COLUMNS`` order
    -> (5, n) int64 rows in ``OUT_COLUMNS`` order. CPU tensor: the plain
    version. CUDA tensor: the kernel on the current stream, or an
    exception."""
    if not isinstance(packed, torch.Tensor):
        raise TypeError("ack_advance: packed must be a torch.Tensor")
    if packed.dtype != torch.int64:
        raise TypeError(f"ack_advance: packed must be int64, got "
                        f"{packed.dtype}")
    if packed.dim() != 2 or packed.shape[0] != len(IN_COLUMNS):
        raise ValueError(f"ack_advance: packed must be (9, n), got "
                         f"{tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("ack_advance: packed must be contiguous")
    n = packed.shape[1]
    if n >= 1 << 30:
        raise ValueError(f"ack_advance: {n} rows exceed the kernel's "
                         f"32-bit grid arithmetic")
    if packed.device.type == "cpu":
        return torch.stack(ack_advance_torch(*packed.unbind(0)))
    if packed.device.type != "cuda":
        raise ValueError(f"ack_advance: unsupported device {packed.device}")
    out = torch.empty((len(OUT_COLUMNS), n), dtype=torch.int64,
                      device=packed.device)
    if n:
        _launch(packed.data_ptr(), n, n, out.data_ptr(),
                torch.cuda.current_stream(packed.device))
    return out


class AckSlot:
    """The buffers of one cohort at bucket ``p``, made once and reused: the
    (9, P) int64 input (``inp``, a numpy view, rows in ``IN_COLUMNS``
    order) and the (5, P) output (``out``, rows in ``OUT_COLUMNS`` order),
    page-locked on a card (plain memory on the CPU), their device
    addresses and one CUDA event. ``home`` is the pool it goes back to."""

    __slots__ = ("p", "home", "host_in", "host_out", "inp", "out", "event",
                 "_ptrs")

    def __init__(self, p: int, device, home=None) -> None:
        cuda = device.type == "cuda"
        self.p, self.home = p, home
        self.host_in = torch.zeros((len(IN_COLUMNS), p), dtype=torch.int64,
                                   pin_memory=cuda)
        self.host_out = torch.zeros((len(OUT_COLUMNS), p), dtype=torch.int64,
                                    pin_memory=cuda)
        self.inp = self.host_in.numpy()
        self.out = self.host_out.numpy()
        self.event = torch.cuda.Event() if cuda else None
        self._ptrs = ((devcfg.device_pointer(self.host_in, "transport"),
                       devcfg.device_pointer(self.host_out, "transport"))
                      if cuda else None)

    def launch(self, n: int, stream=None) -> None:
        """ack_advance of the first ``n`` input columns into the first
        ``n`` output columns: on a card the kernel, reading and writing the
        slot in place, queued on ``stream`` with the event recorded after
        it; on the CPU the plain version at once."""
        if n > self.p:
            raise ValueError(f"ack_advance: {n} rows in a slot of {self.p}")
        if self.event is None:
            self.host_out[:, :n] = torch.stack(
                ack_advance_torch(*self.host_in[:, :n]))
            return
        if n:
            _launch(self._ptrs[0], self.p, n, self._ptrs[1], stream)
        self.event.record(stream)

    def wait(self) -> None:
        """Block until the last launch's result is in ``out``."""
        if self.event is not None:
            self.event.synchronize()


class AckSlots:
    """The free AckSlots of one device, by bucket. ``made`` counts the
    slots ever made: after the first cohort of a bucket it stays put while
    cohorts take and give back one slot at a time."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._free: dict = {}  # bucket -> [AckSlot]
        self.made = 0

    def take(self, n: int) -> AckSlot:
        """A free slot whose bucket holds ``n`` rows, made if there is
        none."""
        p = bucket(n)
        free = self._free.setdefault(p, [])
        if free:
            return free.pop()
        self.made += 1
        return AckSlot(p, self.device, self)

    def give(self, slot: AckSlot) -> None:
        self._free[slot.p].append(slot)


class DeviceAckKernel:
    """ack_advance on a device: the card (the CUDA kernel) or, for
    ``device="cpu"``, the plain PyTorch version. Results equal the numpy
    host version's bit for bit, so routing between them is wall-clock
    policy only. A cohort takes a slot (``slots.take(n)``), fills
    ``slot.inp[:, :n]``, calls ``advance(slot, n)`` and reads the returned
    rows before ``slots.give(slot)``."""

    def __init__(self, device: str = "cuda") -> None:
        self.device = devcfg.select_device(device)
        self._cuda = self.device.type == "cuda"
        self.slots = AckSlots(self.device)
        if self._cuda:
            devcfg.kernel_lib("transport")  # build or load now

    @classmethod
    def attach(cls, device: str = "cuda") -> "DeviceAckKernel":
        """Build (or load) the kernel and run it once on a two-row cohort.
        Raises on a failed build or launch: there is no fallback."""
        k = cls(device)
        z = np.zeros(2, dtype=np.int64)
        k.run(z, z + MIN_CWND, *[z] * 7)
        return k

    def advance(self, slot: AckSlot, n: int) -> np.ndarray:
        """ack_advance of the first ``n`` rows of ``slot``: one launch and
        one event on the current stream, then a wait on that event alone.
        Returns the (5, n) output rows, a view of the slot valid until it
        is given back."""
        slot.launch(n, torch.cuda.current_stream(self.device)
                    if self._cuda else None)
        slot.wait()
        return slot.out[:, :n]

    def run(self, cc_id, cwnd, ssthresh, w_max, epoch_start, snd_una,
            bytes_acked, cum_ack, now) -> tuple:
        """ack_advance of one cohort (nine int64 numpy columns of one
        length), through a slot; returns the five output columns as numpy
        arrays of their own."""
        cols = (cc_id, cwnd, ssthresh, w_max, epoch_start, snd_una,
                bytes_acked, cum_ack, now)
        n = len(cc_id)
        slot = self.slots.take(n)
        try:
            for r, c in enumerate(cols):
                slot.inp[r, :n] = c
            out = self.advance(slot, n)
            return tuple(out[i].copy() for i in range(len(OUT_COLUMNS)))
        finally:
            self.slots.give(slot)
