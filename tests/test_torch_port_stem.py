"""K2's host side on the CPU: the deploy-time weight layout
(``pack_stem_weights``), the tiling (``_k2_plan`` and ``_k2_candidates``)
and the plain version's signature.  The kernel itself runs only on a card
(tests/test_torch_port_cuda.py); its plain version is held against the
JAX package in tests/test_torch_port_s2d.py.

The packed layout must unpack exactly to ``s2d_stem_weights``' matrices,
and every tiling must give each (patch, output plane, output row) to
exactly one block.
"""
import itertools

import numpy as np
import pytest
import torch

from efficientq_tpu_torch.kernels import stem


def _weights(c, o, seed=0):
    rng = np.random.RandomState(seed + 10 * c + o)
    w3 = rng.randn(3, 3, 3, c, o).astype(np.float32)
    return tuple(torch.from_numpy(w).to(torch.bfloat16)
                 for w in stem.s2d_stem_weights(w3))


@pytest.mark.parametrize("c,o", list(itertools.product((1, 4), (8, 32, 40))))
def test_pack_stem_weights_unpacks_to_s2d_weights(c, o):
    we, wo = _weights(c, o)
    c8 = 8 * c
    c8p = -(-c8 // 16) * 16
    packed = stem.pack_stem_weights(we, wo)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (2, o, 8 * c8p)
    taps = packed.reshape(2, o, 8, c8p)
    assert not bool(taps[..., c8:].float().any())  # the zero padding
    for p, w in enumerate((we, wo)):
        # tap = (kd2 * 2 + kh2) * 2 + kw2; rows (kh2, kw2, c8) per kd2
        back = taps[p, :, :, :c8].permute(1, 2, 0).reshape(2, 4 * c8, o)
        assert torch.equal(back.view(torch.int16), w.view(torch.int16))


def k2_tiles(plan, b, d, h):
    """The (patch, z0, z1, h0, h1) of each block of ``plan``, derived from
    the block index as csrc/stem_s2d.cu does: blockIdx.y the patch,
    blockIdx.x = z chunk * bands + band; output planes [z0, z1) and rows
    [h0, h1)."""
    bands = -(-h // plan.rows)
    for by in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            chunk, band = divmod(bx, bands)
            z0, h0 = chunk * plan.zc, band * plan.rows
            yield (by, z0, min(d, z0 + plan.zc), h0, min(h, h0 + plan.rows))


# (B, D, H, W, C8, O): the flagship, odd D, H not a multiple of any band,
# D = 1, a wide O
PLAN_SHAPES = [(8, 64, 64, 64, 32, 32), (2, 23, 12, 20, 8, 40),
               (3, 1, 7, 9, 32, 8), (1, 9, 30, 32, 32, 8),
               (5, 11, 16, 16, 8, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["-".join(map(str, s)) for s in PLAN_SHAPES])
def test_k2_tilings_cover_every_output_once(shape):
    b, d, h, w, c8, o = shape
    plans = [p for _, p in stem._k2_candidates(b, d, h, w, c8, o)]
    assert stem._k2_plan(b, d, h, w, c8, o) in plans
    assert len({(p.rows, p.zc) for p in plans}) == len(plans)
    for plan in plans:
        assert plan.grid[1] == b and plan.threads == 256
        assert plan.smem == stem._k2_smem(w, c8, o, plan.rows)
        seen = np.zeros((b, d, h), np.int64)
        for patch, z0, z1, h0, h1 in k2_tiles(plan, b, d, h):
            assert 0 <= z0 < z1 <= d and 0 <= h0 < h1 <= h
            seen[patch, z0:z1, h0:h1] += 1
        assert (seen == 1).all(), plan


def test_k2_plan_of_the_flagship_is_two_blocks_an_sm():
    """At B = 8 patches of 64^3 outputs: bands of 4 rows, two z chunks,
    256 blocks, two of which fit an SM's shared memory."""
    plan = stem._k2_plan(8, 64, 64, 64, 32, 32)
    assert (plan.rows, plan.zc, plan.grid) == (4, 32, (32, 8))
    assert 2 * (plan.smem + 1024) <= stem.SMEM_SM


def test_k2_plan_rejects_what_does_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        stem._k2_plan(1, 4, 4, 4096, 256, 32)


def test_plain_k2_accepts_and_ignores_packed_weights():
    rng = np.random.RandomState(5)
    c, o, d, h, w = 1, 40, 3, 6, 10
    x = torch.from_numpy(rng.randn(2, d + 1, h, w, 8 * c).astype(
        np.float32)).to(torch.bfloat16)
    par = torch.tensor([0, 1], dtype=torch.int32)
    we, wo = _weights(c, o)
    bias = torch.from_numpy(rng.randn(o).astype(np.float32))
    want = stem.stem_s2d_conv_reference(x, par, we, wo, bias, 0.7, 4)
    for fn in (stem.stem_s2d_conv_reference, stem.stem_s2d_conv):
        got = fn(x, par, we, wo, bias, 0.7, 4,
                 w_packed=stem.pack_stem_weights(we, wo))
        for g, r in zip(got, want):
            assert torch.equal(g, r)
