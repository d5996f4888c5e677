"""Carrying network state across packages (shadow_tpu_torch/convert.py).

The simulator's "weights" are its NetParams: host placement, NIC rates and
bucket capacities, the (G, G) latency table and the q24 drop thresholds.
net_params_from_arrays builds the port's NetParams from the reference's
arrays; the result must equal both the reference's and what the port's own
controller derives for the same config, and loss flags drawn with it must
equal the reference's (tolerance 0: integer math).
"""

import numpy as np
import pytest
import torch

from shadow_tpu.config import load_config as ref_load_config
from shadow_tpu.core.controller import Controller as RefController
from shadow_tpu.network.fluid import loss_flags as ref_loss_flags
from shadow_tpu_torch.config import load_config
from shadow_tpu_torch.convert import FIELDS, net_params_from_arrays
from shadow_tpu_torch.core.controller import Controller
from shadow_tpu_torch.ops import propagate as prop

CFG = "examples/tgen_100host.yaml"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("params")
    ref = RefController(ref_load_config(
        CFG, {"general.data_directory": str(d / "ref"),
              "experimental.tpu_device_floor": -1}), mirror_log=False)
    port = Controller(load_config(
        CFG, {"general.data_directory": str(d / "port"),
              "experimental.scheduler_policy": "tpu_batch",
              "experimental.tpu_device_floor": -1}),
        mirror_log=False, device="cpu")
    return ref, port


def _arrays(params):
    return {k: getattr(params, k) for k in FIELDS}


def test_carried_params_equal_reference(both):
    ref, port = both
    rp = ref.engine.params
    got = net_params_from_arrays(_arrays(rp), rp.seed, ref.round_ns,
                                 ref.cfg.experimental.unit_mtus * 1500)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(rp, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.seed == rp.seed
    # and the port's own controller derives the same state from the config
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(port.engine.params, k),
                                      getattr(rp, k), err_msg=k)


def test_flags_drawn_with_carried_params_match(both):
    ref, _port = both
    rp = ref.engine.params
    got = net_params_from_arrays(_arrays(rp), rp.seed, ref.round_ns)
    rng = np.random.default_rng(11)
    n = 3000
    src = rng.integers(0, len(rp.host_node), n)
    dst = rng.integers(0, len(rp.host_node), n)
    uid = (src.astype(np.uint64) << np.uint64(32)) | rng.integers(
        0, 1 << 20, n).astype(np.uint64)
    lo = (uid & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (uid >> np.uint64(32)).astype(np.uint32)
    npk = rng.integers(1, 11, n).astype(np.uint32)
    th_ref = rp.drop_thresh[rp.host_node[src], rp.host_node[dst]]
    th = got.drop_thresh[got.host_node[src], got.host_node[dst]]
    assert th.any()  # the 0.0005-loss links are live
    want = ref_loss_flags(rp.seed, lo, hi, npk, th_ref)
    plane = prop.DeviceDrawPlane(got.seed, 4096, device="cpu")
    np.testing.assert_array_equal(plane.dispatch(lo, hi, npk, th).read(),
                                  want)
    # and with the arrays as torch hands them back
    x = torch.from_numpy(np.stack([lo[:2048], hi[:2048], npk[:2048],
                                   th[:2048]]).copy())
    bits = prop.draw_flags(x, plane._seed_key(None), 10).numpy()
    np.testing.assert_array_equal(
        np.unpackbits(bits, bitorder="little").astype(bool), want[:2048])


@pytest.mark.parametrize("breakage", ["missing", "float", "cap", "q24",
                                      "shape"])
def test_inconsistent_arrays_are_refused(both, breakage):
    ref, _port = both
    rp = ref.engine.params
    d = dict(_arrays(rp))
    if breakage == "missing":
        del d["cap_up"]
    elif breakage == "float":
        d["rate_up"] = d["rate_up"].astype(np.float64)
    elif breakage == "cap":
        d["cap_down"] = d["cap_down"] + 1
    elif breakage == "q24":
        d["drop_thresh"] = d["drop_thresh"] + np.uint32(1 << 24)
    else:
        d["latency_ns"] = d["latency_ns"][:1]
    with pytest.raises(ValueError):
        net_params_from_arrays(d, rp.seed, ref.round_ns)
