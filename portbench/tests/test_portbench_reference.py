"""The plain reference against Threefry's published answers and against
the program's own plain versions, which the port's tests hold to the JAX
package."""

import numpy as np
import pytest
import torch

from portbench import roofline
from portbench.reference import draws as ref


@pytest.mark.parametrize("key,ctr,want", [
    # Random123's known-answer vectors for threefry2x32_20
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    x0, x1 = ref.threefry2x32(*key, np.array([ctr[0]], np.uint32),
                              np.array([ctr[1]], np.uint32))
    assert (int(x0[0]), int(x1[0])) == want


def _units(rng, n):
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 20, n).astype(np.uint32)
    npk = rng.integers(0, 12, n).astype(np.uint32)
    th = (rng.integers(0, 1 << 24, n) * (rng.random(n) < 0.6)).astype(
        np.uint32)
    return lo, hi, npk, th


@pytest.mark.parametrize("seed", [0, 2, (1 << 31) + 977, (1 << 40) + 3])
def test_loss_flags_match_the_program(seed):
    from shadow_tpu_torch.network.fluid import loss_flags
    from shadow_tpu_torch.ops import propagate

    rng = np.random.default_rng(seed & 0xFFFF)
    lo, hi, npk, th = _units(rng, 5000)
    width = 10
    want = ref.loss_flags(seed, lo, hi, npk, th, width)
    clipped = np.minimum(npk, width).astype(np.uint32)
    assert (loss_flags(seed, lo, hi, clipped, th) == want).all()
    packed = torch.from_numpy(np.stack([lo, hi, npk, th])).contiguous()
    key = (seed & 0xFFFFFFFF, seed >> 32)
    bits = propagate.draw_flags_plain(packed, key, width).numpy()
    got = np.unpackbits(bits, bitorder="little")[:len(lo)].astype(bool)
    assert (got == want).all()
    assert 0 < want.sum() < len(want)
    ctrl = ref.loss_flags(seed, lo, hi, npk, th, width, rounds=13)
    assert (ctrl != want).sum() > 10


def test_lanes_and_bounds():
    lo = np.array([1, 2, 3], np.uint32)
    hi = np.zeros(3, np.uint32)
    npk = np.array([10, 4, 7], np.uint32)
    th = np.array([0, 1 << 24, 1], np.uint32)
    lanes = ref.lanes_to_decide(7, lo, hi, npk, th, 10)
    # no threshold: no draw; every draw is below 2**24: the first lane
    # decides; a threshold of 1 almost never drops: every lane
    assert lanes.tolist() == [0, 1, 7]
    assert roofline.OPS_PER_LANE == 75
    assert roofline.PEAK_INT32_OPS_PER_S == 16.75e12
