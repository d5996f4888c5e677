"""The port's Threefry-2x32-20 twins against the reference generator.

shadow_tpu_torch.ops.prng has a numpy twin (the host loss draws) and a plain
PyTorch twin (int64 masked to 32 bits — the plain version behind the CUDA
kernels); both must equal shadow_tpu.ops.prng.threefry2x32 bit for bit,
traced with numpy and with jax.numpy. Tolerance: 0 (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.ops import prng as ref
from shadow_tpu_torch.ops import prng as port

EDGES = (0, 1, 0xFFFFFFFF, 0x1BD11BDA)


def _inputs(seed: int, n: int = 257):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]


def _all_twins(k0, k1, c0, c1):
    """(reference numpy, reference jnp, port numpy, port torch) outputs as
    uint32 numpy pairs."""
    want_np = ref.threefry2x32(k0, k1, c0, c1, xp=np)
    want_jnp = ref.threefry2x32(jnp.asarray(k0), jnp.asarray(k1),
                                jnp.asarray(c0), jnp.asarray(c1), xp=jnp)
    got_np = port.threefry2x32(k0, k1, c0, c1)
    t = [torch.from_numpy(np.asarray(v, dtype=np.int64)) for v in
         (k0, k1, c0, c1)]
    got_t = port.threefry2x32_torch(*t)
    return (want_np, [np.asarray(v) for v in want_jnp], got_np,
            [v.numpy().astype(np.uint32) for v in got_t])


def _assert_equal(outs):
    want = outs[0]
    for other in outs[1:]:
        for w, g in zip(want, other):
            np.testing.assert_array_equal(np.asarray(w, dtype=np.uint32),
                                          np.asarray(g, dtype=np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_inputs_bitmatch(seed):
    _assert_equal(_all_twins(*_inputs(seed)))


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("arg", range(4))
def test_edge_value_in_every_argument(arg, edge):
    args = _inputs(100 + arg)
    args[arg] = np.full_like(args[arg], edge)
    _assert_equal(_all_twins(*args))


def test_all_edge_combinations():
    grid = np.array(np.meshgrid(*[EDGES] * 4)).reshape(4, -1)
    _assert_equal(_all_twins(*[g.astype(np.uint32) for g in grid]))


def test_torch_twin_stays_32_bit():
    x0, x1 = port.threefry2x32_torch(
        *[torch.from_numpy(v.astype(np.int64)) for v in _inputs(9)])
    for v in (x0, x1):
        assert v.dtype == torch.int64
        assert int(v.min()) >= 0 and int(v.max()) <= 0xFFFFFFFF


def test_quantize_loss_matches_reference():
    rel = np.random.default_rng(5).random((7, 7)).astype(np.float32)
    rel[0, 0], rel[1, 1] = 1.0, 0.0
    np.testing.assert_array_equal(port.quantize_loss(rel),
                                  ref.quantize_loss(rel))


@pytest.mark.parametrize("key", [(11, 0), (0xDEADBEEF, 0x12345678)])
def test_device_wrapper_on_cpu_runs_the_plain_version(key):
    """threefry2x32_device, the wrapper of the function's standalone
    kernel, on a CPU tensor: the reference generator's numbers, no
    launch counted; malformed input refused."""
    c0, c1 = _inputs(7, 1000)[:2]
    before = dict(port.LAUNCHES)
    got = port.threefry2x32_device(torch.from_numpy(np.stack([c0, c1])),
                                   key).numpy()
    want = ref.threefry2x32(np.uint32(key[0]), np.uint32(key[1]), c0, c1,
                            xp=np)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert port.LAUNCHES == before
    with pytest.raises(ValueError):
        port.threefry2x32_device(torch.zeros((3, 4), dtype=torch.uint32), key)
    with pytest.raises(ValueError):
        port.threefry2x32_device(torch.zeros((2, 4), dtype=torch.int64), key)
