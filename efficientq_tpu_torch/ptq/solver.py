"""Closed-form layer-reconstruction solver on Gram matrices (PyTorch).

Counterpart of the JAX package's ``ptq/solver.py``:

- im2col is built on the device, chunked over the output depth so that no
  chunk of the column matrix holds more than ``max_chunk_elems`` floats,
  and each chunk goes straight into the Gram products;
- the ADMM system is factored once per rho value (Cholesky) and each
  iteration does two triangular solves;
- the per-iterate reconstruction loss comes from the Grams, not from
  running the convolution again.

The Grams accumulate in float32; callers hold ``ops.exact_f32()`` so that
cuBLAS does not round the products to TF32.  The best-iterate ranking
(``make_ranking_mse``) runs in float64: in float32 its error exceeds the
loss gaps between ADMM iterates.

Flattened weight convention (torch's): row = output channel, column index =
c_in * kD*kH*kW + kd * kH*kW + kh * kW + kw, with an optional trailing bias
column.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


def kernel_to_flat(k: torch.Tensor) -> torch.Tensor:
    """DHWIO kernel -> (c2, c1*kD*kH*kW) in torch flat order."""
    co = k.shape[-1]
    return k.permute(4, 3, 0, 1, 2).reshape(co, -1)


def flat_to_kernel(w: torch.Tensor, kshape_dhwio) -> torch.Tensor:
    """Inverse of :func:`kernel_to_flat`, as a contiguous DHWIO kernel."""
    kd, kh, kw, ci, co = kshape_dhwio
    return w.reshape(co, ci, kd, kh, kw).permute(2, 3, 4, 1, 0).contiguous()


class GramStats(NamedTuple):
    """Sufficient statistics of the weighted least-squares objective.

    A_att = sum_s att_s x_s x_s^T          (c1k', c1k')
    B_att = sum_s att_s y_s x_s^T          (c2, c1k')
    A_unw/B_unw: same with att = 1
    yy_att = sum_s att_s ||y_s||^2 ; yy_unw = sum_s ||y_s||^2
    c1k' includes the bias (all-ones) row when has_bias.
    """

    A_att: torch.Tensor
    B_att: torch.Tensor
    A_unw: torch.Tensor
    B_unw: torch.Tensor
    yy_att: torch.Tensor
    yy_unw: torch.Tensor
    has_bias: bool
    numel_y: int


def _xcol_chunk(xp, d0, dc, out_hw, ksize, stride, dilation, has_bias):
    """Patch-column matrix for output depth rows [d0, d0+dc):
    (c1k (+1), N*dc*Ho*Wo), rows channel-major then (kd, kh, kw), and a
    trailing ones row with ``has_bias``."""
    kD, kH, kW = ksize
    sD, sH, sW = stride
    lD, lH, lW = dilation
    Ho, Wo = out_hw
    n, c = xp.shape[0], xp.shape[-1]
    taps = kD * kH * kW
    cols = n * dc * Ho * Wo
    xc = torch.empty(c * taps + int(has_bias), cols, dtype=xp.dtype,
                     device=xp.device)
    if has_bias:
        xc[-1] = 1.0
    per_tap = xc[:c * taps].view(c, taps, cols)
    t = 0
    for kd in range(kD):
        for kh in range(kH):
            for kw in range(kW):
                z0 = d0 * sD + kd * lD
                s = xp[:, z0:z0 + (dc - 1) * sD + 1:sD,
                       kh * lH:kh * lH + (Ho - 1) * sH + 1:sH,
                       kw * lW:kw * lW + (Wo - 1) * sW + 1:sW]
                per_tap[:, t] = s.permute(4, 0, 1, 2, 3).reshape(c, cols)
                t += 1
    return xc


def compute_gram_stats(x: torch.Tensor, y: torch.Tensor,
                       att: Optional[torch.Tensor], ksize, stride, padding,
                       dilation=(1, 1, 1), has_bias: bool = True,
                       max_chunk_elems: int = 1 << 27) -> GramStats:
    """GramStats from NDHWC activation ``x`` and NDHWC target ``y``.

    ``att``: optional (N, Do, Ho, Wo) voxel importance, a linear weight on
    the squared error.  The sums are in ``x``'s dtype (float32 in the
    sweep; float64 gives the tests an oracle).  Chunked over the output
    depth, the last chunk ragged, so the column matrix of a chunk holds at
    most ``max_chunk_elems`` floats (one output row at the least)."""
    kD, kH, kW = ksize
    pD, pH, pW = padding
    n = x.shape[0]
    c1 = x.shape[-1]
    _, Do, Ho, Wo, c2 = y.shape
    xp = F.pad(x, (0, 0, pW, pW, pH, pH, pD, pD))
    dim = c1 * kD * kH * kW + int(has_bias)
    per_row = n * Ho * Wo * dim
    chunk_d = max(1, min(Do, int(max_chunk_elems // max(per_row, 1)) or 1))

    acc = dict(dtype=x.dtype, device=x.device)
    A_u = torch.zeros(dim, dim, **acc)
    B_u = torch.zeros(c2, dim, **acc)
    yy_u = torch.zeros((), **acc)
    if att is not None:
        A_a, B_a, yy_a = torch.zeros_like(A_u), torch.zeros_like(B_u), \
            torch.zeros_like(yy_u)
    for d0 in range(0, Do, chunk_d):
        dc = min(chunk_d, Do - d0)
        xc = _xcol_chunk(xp, d0, dc, (Ho, Wo), ksize, stride, dilation,
                         has_bias)
        yc = y[:, d0:d0 + dc].movedim(-1, 0).reshape(c2, -1)
        A_u += xc @ xc.T
        B_u += yc @ xc.T
        yy_u += (yc * yc).sum()
        if att is not None:
            ac = att[:, d0:d0 + dc].reshape(1, -1)
            xh = xc * ac
            A_a += xc @ xh.T
            B_a += yc @ xh.T
            yy_a += (ac * (yc * yc)).sum()
    if att is None:
        A_a, B_a, yy_a = A_u, B_u, yy_u
    return GramStats(A_a, B_a, A_u, B_u, yy_a, yy_u, has_bias,
                     int(np.prod(y.shape)))


def quadratic_mse(stats: GramStats, W_ext: torch.Tensor,
                  weighted: bool) -> torch.Tensor:
    """Mean over y-elements of [att *] ||W_ext columns - y||^2 via the
    Grams (float32)."""
    A = stats.A_att if weighted else stats.A_unw
    B = stats.B_att if weighted else stats.B_unw
    yy = stats.yy_att if weighted else stats.yy_unw
    val = ((W_ext @ A) * W_ext).sum() - 2.0 * (W_ext * B).sum() + yy
    return val / stats.numel_y


def make_ranking_mse(stats: GramStats):
    """Cancellation-free evaluator of the unweighted quadratic MSE, for
    ranking ADMM iterates, in float64.

    The naive form tr(WAW^T) - 2tr(WB^T) + yy subtracts numbers of size
    ~S*E[y^2] to leave a residual ~S*mse.  Rewritten exactly around the
    (ridged) least-squares solution Wls:

        q(W) = r A r^T + 2 r.(A Wls^T - B^T) + q(Wls),   r = W - Wls

    The first term is a small positive quadratic in the quantization
    excess, the second is tiny, the third a constant.  The JAX package
    evaluates this in float32, where on a 433-column layer its error is
    3.67x the smallest gap between six ADMM candidates and it ranks them
    wrongly; the same rewrite in float64 from the same float32 Grams has
    an error of 0.00096x the gap.  So the float32 Grams are cast to
    float64 and the ridge Cholesky, Wls, the gradient term and each
    candidate's form are float64; the loss is a float64 scalar."""
    A = stats.A_unw.double()
    B = stats.B_unw.double()
    dim = A.shape[0]
    lam = 1e-6 * (torch.trace(A) / dim) + 1e-30
    eye = torch.eye(dim, dtype=torch.float64, device=A.device)
    L, _ = torch.linalg.cholesky_ex(A + lam * eye)
    Wls = torch.cholesky_solve(B.T, L).T
    g = Wls @ A - B
    c0 = (((Wls @ A) * Wls).sum() - 2.0 * (Wls * B).sum()
          + stats.yy_unw.double()) / stats.numel_y

    def loss(W_ext: torch.Tensor) -> torch.Tensor:
        r = W_ext.double() - Wls
        val = ((r @ A) * r).sum() + 2.0 * (r * g).sum()
        return val / stats.numel_y + c0

    return loss


def make_system(stats: GramStats, rho, eta, mu=0.0) -> torch.Tensor:
    """A of the proximal system for a given rho: with bias
    A = 2*A_att + (rho+mu)*quasi_eye + eta*I (the bias diagonal gets eta
    only); without, A = 2*A_att + (rho+mu+eta)*I."""
    dim = stats.A_att.shape[0]
    eye = torch.eye(dim, dtype=torch.float32, device=stats.A_att.device)
    if stats.has_bias:
        quasi = eye.clone()
        quasi[dim - 1, dim - 1] = 0.0
        return 2.0 * stats.A_att + (rho + mu) * quasi + eta * eye
    return 2.0 * stats.A_att + (rho + mu + eta) * eye


def solve_proximal(chol: torch.Tensor, stats: GramStats, rho, eta,
                   G_flat: torch.Tensor, W0_ext: torch.Tensor):
    """Given the Cholesky factor ``chol`` of A, solve A W^T = B^T for W,
    with B = 2*B_att + eta*W0_ext (+ rho*G on the weight columns).
    Returns (w_star, b_star); b_star is zeros(c2) without a bias."""
    B = 2.0 * stats.B_att + eta * W0_ext
    if stats.has_bias:
        B = torch.cat([B[:, :-1] + rho * G_flat, B[:, -1:]], dim=1)
    else:
        B = B + rho * G_flat
    W = torch.cholesky_solve(B.T, chol).T
    if stats.has_bias:
        return W[:, :-1], W[:, -1]
    return W, torch.zeros(W.shape[0], dtype=W.dtype, device=W.device)
