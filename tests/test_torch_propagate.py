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


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", [1, 10, 64])
@pytest.mark.parametrize("p", [256, 1024])
def test_draw_flags_plain_matches_reference_kernel(p, width, seed):
    rng = np.random.default_rng(p + width)
    x = _packed(_batch(rng, p, width), p)
    want = np.asarray(ref_prop._draw_kernel(x, _key(seed), width=width))
    got = prop.draw_flags(torch.from_numpy(x), _key(seed), width)
    assert got.dtype == torch.uint8 and got.shape == (p // 8,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", [1, 10, 64])
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
