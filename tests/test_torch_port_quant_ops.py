"""The port's quantizers and NDHWC ops against the JAX package, on the same
NumPy inputs; and the port importing with JAX blocked.

Tolerances: the quantizers, packing, pooling, relu and layout helpers are
exact (same float32 ops in the same order).  Float convs, trilinear
upsampling and batch norm sum or combine in another order than XLA's CPU
backend: rtol/atol 1e-5 (convs) and 1e-6 (elementwise).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import ops as jops
from efficientq_tpu import quant as jq
from efficientq_tpu_torch import ops, quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(shape, seed=0, scale=1.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("lvl,lo,hi", [(4, -1.0, 1.0), (4, 0.0, 1.0),
                                       (16, -1.0, 1.0), (256, 0.0, 1.0)])
def test_discretize_matches_jax(lvl, lo, hi):
    x = _x((4, 5, 6), seed=lvl)
    want = np.asarray(jq.discretize(jnp.asarray(x), lvl, lo, hi))
    got = quant.discretize(torch.from_numpy(x), lvl, lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lvl", [4, 8, 256])
def test_fake_quant_matches_jax(lvl):
    x = _x((3, 4, 5, 6), seed=lvl)
    a = np.float32(0.73)
    np.testing.assert_array_equal(
        quant.fake_quant_weight(torch.from_numpy(x), torch.tensor(a), lvl),
        np.asarray(jq.fake_quant_weight(jnp.asarray(x), a, lvl)))
    np.testing.assert_array_equal(
        quant.fake_quant_act(torch.from_numpy(x), torch.tensor(a), lvl),
        np.asarray(jq.fake_quant_act(jnp.asarray(x), a, lvl)))


def test_act_codes_match_jax_prologue():
    x = _x((2, 3, 4, 5, 6))
    a, n = np.float32(0.9), 4
    want = np.asarray(jnp.round(jnp.clip(jnp.asarray(x) / a, 0.0, 1.0)
                                * (n - 1)).astype(jnp.int8))
    got = quant.act_codes(torch.from_numpy(x), torch.tensor(a), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_ste_round_gradient_is_straight_through():
    x = torch.tensor([0.4, 1.5, -2.6], requires_grad=True)
    y = quant.ste_round(x)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), [0.0, 2.0, -3.0])
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, 1.0, 1.0])


@pytest.mark.parametrize("lvl,alpha", [(4, 0.37), (256, 0.11),
                                       (4, np.array([0.3, 0.5, 0.7]))])
def test_pack_unpack_match_jax(lvl, alpha):
    w = _x((3, 2, 3, 3, 3), seed=3)
    wq = np.asarray(jq.fake_quant_weight(
        jnp.asarray(w), jnp.asarray(np.reshape(alpha, (-1,) + (1,) * 4)
                                    if np.ndim(alpha) else alpha,
                                    jnp.float32), lvl))
    codes = quant.pack_int_weight(wq, alpha, lvl)
    np.testing.assert_array_equal(codes, jq.pack_int_weight(wq, alpha, lvl))
    np.testing.assert_array_equal(quant.unpack_int_weight(codes, alpha, lvl),
                                  jq.unpack_int_weight(codes, alpha, lvl))


@pytest.mark.parametrize("lvl", [4, 16])
def test_project_by_iter_np_matches_jax(lvl):
    v = _x((200,), seed=lvl)
    a, b = quant.project_by_iter_np(v, lvl)
    ja, jb = jq.project_by_iter_np(v, lvl)
    assert a == ja
    np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("stride,padding,dilation", [
    (1, 1, 1), (2, 1, 1), (1, 2, 2), (1, 0, 1)])
def test_conv3d_matches_jax(stride, padding, dilation):
    x = _x((2, 7, 8, 9, 3), seed=1)
    k = _x((3, 3, 3, 3, 5), seed=2, scale=0.3)
    b = _x((5,), seed=3)
    want = np.asarray(jops.conv3d(jnp.asarray(x), jnp.asarray(k),
                                  jnp.asarray(b), stride, padding, dilation,
                                  precision=jax.lax.Precision.HIGHEST))
    with ops.exact_f32():
        got = ops.conv3d(torch.from_numpy(x), torch.from_numpy(k),
                         torch.from_numpy(b), stride, padding, dilation)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pool_upsample_bn_relu_match_jax():
    x = _x((2, 5, 6, 7, 3))
    np.testing.assert_array_equal(
        ops.max_pool3d(torch.from_numpy(x), 2).numpy(),
        np.asarray(jops.max_pool3d(jnp.asarray(x), 2)))
    for f in (2, (2, 2, 1)):
        np.testing.assert_allclose(
            ops.upsample3d(torch.from_numpy(x), f).numpy(),
            np.asarray(jops.upsample3d(jnp.asarray(x), f)),
            rtol=1e-6, atol=1e-6)
    s, b, m = _x((3,), 4), _x((3,), 5), _x((3,), 6)
    v = np.abs(_x((3,), 7)) + 0.5
    np.testing.assert_allclose(
        ops.batch_norm(*map(torch.from_numpy, (x, s, b, m, v))).numpy(),
        np.asarray(jops.batch_norm(*map(jnp.asarray, (x, s, b, m, v)))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ops.relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jops.relu(jnp.asarray(x))))


def test_layout_helpers_match_jax():
    x = _x((2, 3, 4, 5, 6))
    k = _x((3, 3, 3, 4, 5))
    t = torch.from_numpy
    np.testing.assert_array_equal(ops.ndhwc_to_ncdhw(t(x)).numpy(),
                                  np.asarray(jops.ndhwc_to_ncdhw(x)))
    np.testing.assert_array_equal(ops.ncdhw_to_ndhwc(t(x)).numpy(),
                                  np.asarray(jops.ncdhw_to_ndhwc(x)))
    np.testing.assert_array_equal(ops.dhwio_to_oidhw(t(k)).numpy(),
                                  np.asarray(jops.dhwio_to_oidhw(k)))
    np.testing.assert_array_equal(
        ops.oidhw_to_dhwio(ops.dhwio_to_oidhw(t(k))).numpy(), k)
    # NDHWC storage is NCDHW in channels_last_3d: the permute is a view
    assert ops.ndhwc_to_ncdhw(t(x)).is_contiguous(
        memory_format=torch.channels_last_3d)


def test_exact_f32_restores_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with ops.exact_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports with ``jax``
    and the JAX package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['efficientq_tpu'] = None\n"
        "import efficientq_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'efficientq_tpu_torch.')]\n"
        "assert 'efficientq_tpu_torch.kernels.stem' in names, names\n"
        "names.append('chip_smoke')\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'efficientq_tpu.'))"
        " or m == 'efficientq_tpu' for m in sys.modules if sys.modules[m]), "
        "sorted(m for m in sys.modules if 'jax' in m)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
