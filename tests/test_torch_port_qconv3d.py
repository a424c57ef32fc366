"""K1 (the int8 3^3 conv with fused epilogues): the port's plain version
against the JAX package's Pallas kernel (interpret mode) and its XLA
realization ``_xla_qconv3x3``.  The cases are shared with
test_torch_port_cuda.py, which holds the CUDA kernel against the plain
version on a card.

Tolerances.  int8 outputs are compared exactly.  float32 outputs equal
``_xla_qconv3x3`` exactly: the port computes the same ops in the same
order (exact integer accumulation, then ``* scale`` and ``+ bias`` rounded
separately).  The interpret-mode Pallas kernel is compiled by XLA's CPU
backend, which fuses ``acc * scale + bias`` into one FMA, so there the
float32 outputs agree to within 1 ulp of the largest operand of that
multiply-add (and of the residual add after it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu.pallas.qconv3d import _xla_qconv3x3
from efficientq_tpu.pallas.qconv3d import qconv3x3_int8_ndhwc as jax_k1
from efficientq_tpu_torch.kernels import qconv3d as K
from test_torch_port_cuda import CASES, NA, make_case, run_port


def _jax(case):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = jax_k1(j(case["x"]), j(case["codes"]), j(case["bias"]),
                 jnp.float32(case["alpha"]), j(case["scale"]), NA,
                 interpret=True, residual=j(case["residual"]), **case["kw"])
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                         else (out,)))


def _xla(case):
    kw = case["kw"]
    x = jnp.asarray(case["x"])
    qa = x if kw["x_quantized"] else jnp.round(
        jnp.clip(x / case["alpha"], 0.0, 1.0) * (NA - 1)).astype(jnp.int8)
    res = None if case["residual"] is None else jnp.asarray(case["residual"])
    out = _xla_qconv3x3(qa, jnp.asarray(case["codes"]),
                        jnp.asarray(case["bias"]), jnp.asarray(case["scale"]),
                        kw["dilation"], jnp.float32, res, kw["residual_relu"],
                        jnp.float32(kw.get("quant_alpha", 1.0)),
                        kw.get("quant_qlvl", 0), kw["pool"])
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                         else (out,)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k1_matches_jax(name):
    case = make_case(sorted(CASES).index(name), **CASES[name])
    got, xla, pallas = run_port(case), _xla(case), _jax(case)
    assert [g.shape for g in got] == [r.shape for r in xla]
    # FMA bound for the interpret-mode kernel: 1 ulp of the largest operand
    bound = np.abs(case["bias"])
    if case["residual"] is not None:
        bound = bound + np.abs(case["residual"]).max()
    for g, x, p in zip(got, xla, pallas):
        assert g.dtype == x.dtype == p.dtype
        np.testing.assert_array_equal(g, x)
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, p)
        else:
            ulp = np.spacing((np.abs(g) + bound).astype(np.float32))
            assert np.all(np.abs(g - p) <= ulp), np.abs(g - p).max()


def test_pack_weights_layout():
    """Word k of tap t, channel o holds input channels 4k..4k+3 in bytes
    0..3; missing channels are zero."""
    rng = np.random.RandomState(0)
    codes = rng.randint(-7, 8, size=(3, 3, 3, 5, 2)).astype(np.int8)
    packed = K.pack_weights(torch.from_numpy(codes)).numpy()
    assert packed.shape == (27, 2, 2) and packed.dtype == np.int32
    as_bytes = packed.view(np.int8).reshape(27, 2, 2, 4)
    flat = codes.reshape(27, 5, 2)
    for c in range(8):
        want = flat[:, c] if c < 5 else 0
        np.testing.assert_array_equal(as_bytes[:, c // 4, :, c % 4], want)


def test_wrapper_dispatches_by_device():
    """CPU tensors take the plain version and count no launch."""
    case = make_case(0, **CASES["plain-c4-dil2"])
    before = K.qconv3x3_int8_ndhwc.launches
    np.testing.assert_array_equal(
        run_port(case)[0], run_port(case, K.qconv3x3_int8_ndhwc_reference)[0])
    assert K.qconv3x3_int8_ndhwc.launches == before
    with pytest.raises(ValueError, match="CUDA or"):
        K.qconv3x3_int8_ndhwc(torch.zeros(1, 2, 2, 2, 4, device="meta"),
                              torch.zeros(3, 3, 3, 4, 4, dtype=torch.int8),
                              None, 1.0, 1.0, NA)
