"""The port's loss-draw kernels (plain PyTorch versions and the
DeviceDrawPlane around them) against the reference's device programs.

shadow_tpu_torch/ops/propagate.py holds, per kernel, a hand-written CUDA
kernel (csrc/draw.cu) and a plain PyTorch version that a wrapper runs for
CPU tensors. On this CPU box the plain versions stand in; they are held bit
for bit (tolerance 0: integer math) against the reference's jitted
_draw_kernel / _min_draw_kernel on CPU-XLA (as tests/test_bitmatch.py runs
them) and against the host twin fluid.loss_flags. The CUDA kernels are held
against the plain versions on the card by test_kernels_match_plain_on_card
(marker ``cuda``) and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from shadow_tpu.network import fluid as ref_fluid
from shadow_tpu.ops import propagate as ref_prop
from shadow_tpu_torch.network import fluid as port_fluid
from shadow_tpu_torch.ops import propagate as prop

SEEDS = (0xDEADBEEF, (1 << 32) + 12345)


def _batch(rng, n, width, rows=4, npk_edges=True, th_edges=True):
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 26, n, dtype=np.uint64).astype(np.uint32)
    npk = rng.integers(0, width + 2, n).astype(np.uint32)
    if npk_edges:
        npk[::7] = 0
        npk[1::11] = width
    th = rng.choice(np.array([0, 1, 1 << 10, 1 << 20, (1 << 24) - 1,
                              1 << 24], np.uint32), n)
    if th_edges:
        th[::5] = 0
    return (lo, hi, npk, th)[:rows]


def _packed(cols, p):
    out = np.zeros((len(cols), p), np.uint32)
    for r, c in enumerate(cols):
        out[r, :len(c)] = c
    return out


def _key(seed):
    return np.array([seed & 0xFFFFFFFF, seed >> 32], np.uint32)


#: the lane widths: the default, one lane, each side of a warp-wide segment
#: (16, 31, 32, 33: one lane a thread up to 32, two above) and the most
WIDTHS = [1, 10, 16, 31, 32, 33, 64]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("p", [256, 1024])
def test_draw_flags_plain_matches_reference_kernel(p, width, seed):
    rng = np.random.default_rng(p + width)
    x = _packed(_batch(rng, p, width), p)
    want = np.asarray(ref_prop._draw_kernel(x, _key(seed), width=width))
    got = prop.draw_flags(torch.from_numpy(x), _key(seed), width)
    assert got.dtype == torch.uint8 and got.shape == (p // 8,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("p", [256, 16384])
def test_min_draw_plain_matches_reference_kernel(p, width, seed):
    rng = np.random.default_rng(p * 3 + width)
    x = _packed(_batch(rng, p, width, rows=3), p)
    want = np.asarray(ref_prop._min_draw_kernel(x, _key(seed), width=width))
    got = prop.min_draw(torch.from_numpy(x), _key(seed), width)
    assert got.dtype == torch.uint32 and got.shape == (p,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[x[2] == 0] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("n", [1, 255, 257, 700])
def test_draw_flags_match_host_twin(n):
    """Within the lane width, the kernel's flags are the host twin's
    (fluid.loss_flags, both packages)."""
    rng = np.random.default_rng(n)
    lo, hi, npk, th = _batch(rng, n, 10)
    npk = np.minimum(npk, 10)  # the twin draws every lane; cap to width
    got = prop.DeviceDrawPlane(SEEDS[0], 4096, device="cpu").dispatch(
        lo, hi, npk, th).read()
    np.testing.assert_array_equal(
        got, ref_fluid.loss_flags(SEEDS[0], lo, hi, npk, th))
    np.testing.assert_array_equal(
        got, port_fluid.loss_flags(SEEDS[0], lo, hi, npk, th))
    assert not got[th == 0].any() and not got[npk == 0].any()


@pytest.mark.parametrize("override", [None, 7, (1 << 40) + 3])
@pytest.mark.parametrize("n", [1, 255, 257, 700, 3000])
def test_plane_dispatch_matches_reference_plane(n, override):
    rng = np.random.default_rng(1000 + n)
    cols = _batch(rng, n, 10)
    ref_plane = ref_prop.DeviceDrawPlane(seed=99, max_batch=4096)
    plane = prop.DeviceDrawPlane(seed=99, max_batch=4096, device="cpu")
    want = ref_plane.dispatch(*cols, seed=override).read()
    h = plane.dispatch(*cols, seed=override)
    assert h.is_ready()
    np.testing.assert_array_equal(h.read(), want)
    want_m = ref_plane.dispatch_min(*cols[:3], min_bucket=4096,
                                    seed=override).read()
    got_m = plane.dispatch_min(*cols[:3], min_bucket=4096,
                               seed=override).read()
    assert got_m.dtype == np.uint32
    np.testing.assert_array_equal(got_m, want_m)


@pytest.mark.parametrize("n", [0, 1, 33, 200])
def test_wrappers_ignore_units_past_n(n):
    """Units past n are padding whatever their columns hold: their flags
    read 0 and their minima SENTINEL, and the real units' results are the
    reference's on the zero-padded batch."""
    rng = np.random.default_rng(n + 5)
    p, key = 256, _key(SEEDS[1])
    real = _packed(_batch(rng, n, 10), p)
    stale = real.copy()
    stale[:, n:] = _packed(_batch(rng, p, 10), p)[:, n:]
    want = np.asarray(ref_prop._draw_kernel(real, key, width=10))
    got = prop.draw_flags(torch.from_numpy(stale), key, 10, n=n)
    np.testing.assert_array_equal(got.numpy(), want)
    want_m = np.asarray(ref_prop._min_draw_kernel(real[:3], key, width=10))
    got_m = prop.min_draw(torch.from_numpy(stale[:3].copy()), key, 10, n=n)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert (got_m.numpy()[n:] == prop.SENTINEL).all()


def _ref_flags(cols, seed, width=10):
    """The reference's _draw_kernel on ``cols`` zero-padded to its bucket:
    the (n,) flags."""
    n = len(cols[0])
    x = _packed(cols, prop._bucket(n, 1 << 16))
    out = np.asarray(ref_prop._draw_kernel(x, _key(seed), width=width))
    return np.unpackbits(out, bitorder="little")[:n].astype(bool)


def _ref_mins(cols, seed, p, width=10):
    x = _packed(cols, p)
    return np.asarray(ref_prop._min_draw_kernel(x, _key(seed),
                                                width=width))[:len(cols[0])]


def test_plane_slots_in_flight_read_in_reverse():
    """Five dispatches in flight on one bucket, read last first: each has a
    slot of its own and reads the reference's flags."""
    rng = np.random.default_rng(41)
    plane = prop.DeviceDrawPlane(SEEDS[0], 65536, device="cpu")
    batches = [_batch(rng, n, 10) for n in (200, 17, 256, 1, 90)]
    handles = [plane.dispatch(*b) for b in batches]
    assert plane.slots("draw_flags", 256) == []  # all five in flight
    for b, h in reversed(list(zip(batches, handles))):
        np.testing.assert_array_equal(h.read(), _ref_flags(b, SEEDS[0]))
    assert len(plane.slots("draw_flags", 256)) == 5


def test_plane_bucket_sequence_large_small_large():
    """65,536 / 256 / 65,536-unit buckets in turn, the second large batch
    smaller than the first: the reused slot reads no stale unit."""
    rng = np.random.default_rng(43)
    plane = prop.DeviceDrawPlane(SEEDS[1], 65536, device="cpu")
    for n in (60000, 200, 40000):
        b = _batch(rng, n, 10)
        h = plane.dispatch(*b)
        slot = h._slot
        np.testing.assert_array_equal(h.read(), _ref_flags(b, SEEDS[1]))
        # the whole output, pads included, is the plain version's on the
        # zero-padded batch
        p = prop._bucket(n, 65536)
        want = prop.draw_flags_plain(torch.from_numpy(_packed(b, p)),
                                     _key(SEEDS[1]), 10)
        np.testing.assert_array_equal(slot.out, want.numpy())
    assert len(plane.slots("draw_flags", 65536)) == 1


def test_min_draw_result_survives_slot_reuse():
    rng = np.random.default_rng(47)
    plane = prop.DeviceDrawPlane(SEEDS[0], 65536, device="cpu")
    a, b = _batch(rng, 3000, 10, rows=3), _batch(rng, 5000, 10, rows=3)
    first = plane.dispatch_min(*a, min_bucket=plane.SPEC_BUCKET).read()
    kept = first.copy()
    second = plane.dispatch_min(*b, min_bucket=plane.SPEC_BUCKET).read()
    assert len(plane.slots("min_draw", plane.SPEC_BUCKET)) == 1  # reused
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(
        first, _ref_mins(a, SEEDS[0], plane.SPEC_BUCKET))
    np.testing.assert_array_equal(
        second, _ref_mins(b, SEEDS[0], plane.SPEC_BUCKET))


def test_dropped_handle_gives_its_slot_back():
    rng = np.random.default_rng(53)
    plane = prop.DeviceDrawPlane(SEEDS[0], 4096, device="cpu")
    h = plane.dispatch_min(*_batch(rng, 10, 10, rows=3))
    assert plane.slots("min_draw", 256) == []
    del h
    assert len(plane.slots("min_draw", 256)) == 1


def test_plane_warm_and_calibrate_through_slots():
    """warm_shapes leaves a slot in every bucket; calibrate and later
    dispatches reuse them (a second slot appears only for a second batch
    in flight) and read the reference's flags."""
    plane = prop.DeviceDrawPlane(SEEDS[1], 1024, device="cpu")
    plane.warm_shapes()
    for p in (256, 512, 1024):
        assert len(plane.slots("draw_flags", p)) == 1
    assert len(plane.slots("min_draw", plane.SPEC_BUCKET)) == 1
    plane.calibrate(n_probe=512)
    assert len(plane.slots("draw_flags", 512)) == 1
    rng = np.random.default_rng(59)
    batches = [_batch(rng, n, 10) for n in (700, 3, 512, 400)]
    handles = [plane.dispatch(*b) for b in batches]
    for b, h in zip(batches, handles):
        np.testing.assert_array_equal(h.read(), _ref_flags(b, SEEDS[1]))
    assert [len(plane.slots("draw_flags", p)) for p in (256, 512, 1024)] \
        == [1, 2, 1]


def test_plane_warm_and_calibrate_on_cpu():
    plane = prop.DeviceDrawPlane(seed=3, max_batch=1024, device="cpu")
    before = dict(prop.LAUNCHES)
    plane.warm_shapes()
    dev_s, np_per_unit = plane.calibrate(n_probe=512)
    assert dev_s > 0 and np_per_unit > 0
    # the plain versions on CPU tensors are not kernel launches
    assert prop.LAUNCHES == before


@pytest.mark.parametrize("bad, err", [
    (lambda: torch.zeros((4, 256), dtype=torch.int32), TypeError),
    (lambda: torch.zeros((3, 256), dtype=torch.uint32), ValueError),
    (lambda: torch.zeros((4, 100), dtype=torch.uint32), ValueError),
    (lambda: torch.zeros((256, 4), dtype=torch.uint32).t(), ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, err):
    with pytest.raises(err):
        prop.draw_flags(bad(), (0, 0), 10)


def test_wrapper_rejects_bad_width():
    with pytest.raises(ValueError):
        prop.min_draw(torch.zeros((3, 256), dtype=torch.uint32), (0, 0), 65)


@pytest.mark.parametrize("n", [-1, 257])
def test_wrapper_rejects_bad_unit_count(n):
    with pytest.raises(ValueError):
        prop.draw_flags(torch.zeros((4, 256), dtype=torch.uint32), (0, 0),
                        10, n=n)


def test_bucket_shapes():
    assert prop._bucket(1, 65536) == 256
    assert prop._bucket(256, 65536) == 256
    assert prop._bucket(257, 65536) == 512
    assert prop._bucket(692, 65536) == 1024


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card (also
    covered, over the full sweep, by chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for p in (256, 1024, 65536):
        for width in (1, 10, 64):
            for seed in SEEDS:
                x = torch.from_numpy(_packed(_batch(rng, p, width), p)).to(dev)
                assert torch.equal(prop.draw_flags(x, _key(seed), width),
                                   prop.draw_flags_plain(x, _key(seed), width))
                x3 = x[:3].contiguous()
                assert torch.equal(prop.min_draw(x3, _key(seed), width),
                                   prop.min_draw_plain(x3, _key(seed), width))
