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
from efficientq_tpu_torch.kernels.build import SMEM_BLOCK, SMS
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
    """packed[tap, o, c] holds input channel c of output channel o (the
    mma's B fragment runs along c); channels past C, up to the next
    multiple of 32, are zero."""
    rng = np.random.RandomState(0)
    codes = rng.randint(-7, 8, size=(3, 3, 3, 37, 2)).astype(np.int8)
    packed = K.pack_weights(torch.from_numpy(codes)).numpy()
    assert packed.shape == (27, 2, 64) and packed.dtype == np.int8
    flat = codes.reshape(27, 37, 2)
    np.testing.assert_array_equal(packed[:, :, :37],
                                  flat.transpose(0, 2, 1))
    assert not packed[:, :, 37:].any()


# (N, D, H, W, C, O, dilation): the flagship's 14 convs at the s2d batch
# (8) and the float32 batch (2), and odd, small and wide geometries
PLAN_CASES = [
    (8, 64, 64, 64, 32, 32, 1), (2, 64, 64, 64, 32, 32, 2),
    (8, 32, 32, 32, 64, 64, 1), (2, 32, 32, 32, 64, 64, 1),
    (8, 16, 16, 16, 128, 128, 1), (2, 16, 16, 16, 128, 128, 2),
    (8, 8, 8, 8, 256, 256, 1), (2, 8, 8, 8, 256, 256, 1),
    (1, 5, 6, 7, 3, 6, 1), (3, 1, 1, 1, 8, 3, 1), (2, 9, 9, 9, 40, 72, 2),
    (1, 3, 17, 2, 72, 40, 1), (4, 7, 13, 11, 256, 256, 3),
    (1, 6, 6, 6, 4, 6, 9), (8, 64, 64, 64, 32, 32, 40),
]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=["x".join(map(str, c)) for c in PLAN_CASES])
def test_tile_plan_covers_each_output_once(case):
    """Every output voxel and channel belongs to exactly one block; bricks
    are even and start on even coordinates, so no 2x2x2 pool cell spans
    two blocks; the grid and shared memory are what the launch takes."""
    n, d, h, w, c, o, dil = case
    plan = K._tile_plan(n, d, h, w, c, o, dil)
    gx, gy = plan.grid
    bz, by, bx = plan.brick
    assert (bz, by) in K._BRICKS and bx == 8
    assert plan.threads == bz * by * bx and plan.threads % 32 == 0
    assert plan.smem == K._smem_bytes(plan.brick, c, dil)
    assert plan.smem <= SMEM_BLOCK
    assert 1 <= gx <= plan.n_bricks == int(np.prod(plan.bricks))
    assert gy * plan.bn >= o > (gy - 1) * plan.bn
    owned = np.zeros((n, d, h, w), np.int32)
    for block in range(gx):
        for b in range(block, plan.n_bricks, gx):
            ni, z0, y0, x0 = K._brick_origin(plan, b)
            assert z0 % bz == y0 % by == x0 % bx == 0
            owned[ni, z0:z0 + bz, y0:y0 + by, x0:x0 + bx] += 1
    assert (owned == 1).all()  # each column tile walks the same bricks


def test_tile_plan_fills_the_card_at_the_flagship():
    """At the flagship's first stage the blocks fill every SM at least
    twice over and are the largest bricks, and the widest convs still
    spread over every SM."""
    big = K._tile_plan(8, 64, 64, 64, 32, 32, 1)
    assert big.brick == (4, 8, 8) and big.grid[0] >= 2 * SMS
    for n in (2, 8):
        plan = K._tile_plan(n, 8, 8, 8, 256, 256, 1)
        assert plan.grid[0] * plan.grid[1] >= SMS


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
