"""Per-layer ADMM calibration, the EfficientQ proximal quantizer (PyTorch).

Counterpart of the JAX package's ``ptq/admm.py``:

- rho/eta scaled by max(y_dim*y_std / (w_dim*w_std), 1) * mean(att)
- ADMM iterations: closed-form proximal solve -> ``project_by_iter``
  projection -> dual update -> rho doubling every 50 iterations (dual
  rescaled) -> best iterate tracked by the unweighted reconstruction MSE
- returns the best (G, bias, alpha_w) and the final attention-weighted loss

The rho schedule is a Python loop over its segments: one Cholesky
factorization per distinct rho, then that segment's iterations of two
triangular solves and a projection each.  The best iterate is picked on
the device (``torch.where``); the only host reads inside an iteration are
the projection's convergence checks (``quant.project_by_iter``), and the
history comes back once per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..quant import fake_quant_act_k, project_by_iter, project_by_iter_rows
from ..utils.tracing import device_mark, device_seconds
from .solver import (GramStats, compute_gram_stats, flat_to_kernel,
                     kernel_to_flat, make_ranking_mse, make_system,
                     quadratic_mse, solve_proximal)

HISTORY_KEYS = ("loss", "primal_residual", "dual_residual", "rho")


@dataclasses.dataclass(frozen=True)
class PTQHyperParams:
    """lwq_* hyper-parameters of the calibration."""

    admm_iter: int = 200
    rho: float = 10.0
    rho_max: float = 1000.0
    eta: float = 1.0
    mu: float = 0.0
    rho_update_interval: int = 50
    # per-output-channel alpha_w
    channel_wise: bool = False
    # per-output-channel bias correction after ADMM: the grid-constrained
    # kernel's (weighted) mean residual per channel is absorbed into the
    # bias, the exact minimizer of the same objective over a shift
    bias_corr: bool = False


def rho_segments(hp: PTQHyperParams) -> List[Tuple[float, int, float]]:
    """(rho_multiplier, n_iters, dual_factor_after) segments of the
    schedule: at every iteration with i % N == 0 (after the solve) rho
    doubles (the dual halves) until rho_max, then clamps (dual *=
    rho/rho_max)."""
    mults, factors = [], []
    r = hp.rho
    for i in range(hp.admm_iter):
        mults.append(r)
        if i % hp.rho_update_interval == 0:
            if r * 2 <= hp.rho_max:
                r = r * 2
                factors.append(0.5)
            else:
                factors.append(r / hp.rho_max)
                r = hp.rho_max
        else:
            factors.append(1.0)
    segments = []
    start = 0
    for i in range(1, hp.admm_iter + 1):
        if i == hp.admm_iter or mults[i] != mults[start]:
            segments.append((mults[start], i - start, factors[i - 1]))
            start = i
    return segments


def admm_quantize(w_flat0: torch.Tensor, bias0: Optional[torch.Tensor],
                  stats: GramStats, qlvl_w: int, rho_scale: torch.Tensor,
                  hp: PTQHyperParams, loss_fn=None):
    """Run the ADMM loop on precomputed Grams.

    ``loss_fn(W_flat, bias) -> scalar`` overrides the per-iterate loss used
    for best tracking (default: the float64 ranking form of the Grams).

    Returns (bestG_flat, bestB, best_alpha_w, best_loss, history):
    ``history`` maps "loss", "primal_residual", "dual_residual" and "rho"
    to (admm_iter,) float64 host tensors, read back in one transfer.
    """
    c2 = w_flat0.shape[0]
    dev = w_flat0.device
    has_bias = stats.has_bias
    if has_bias:
        assert bias0 is not None
        W0_ext = torch.cat([w_flat0, bias0[:, None]], dim=1)
    else:
        W0_ext = w_flat0
    if not isinstance(rho_scale, torch.Tensor):
        rho_scale = torch.full((), rho_scale, dtype=torch.float32, device=dev)
    eta = hp.eta * rho_scale

    def project(v):
        """(alpha, alpha*codes): per-tensor or per-output-channel scale."""
        if hp.channel_wise:
            a_w, b_w = project_by_iter_rows(v, qlvl_w, -1.0, 1.0)
            return a_w, a_w[:, None] * b_w
        a_w, b_w = project_by_iter(v, qlvl_w, -1.0, 1.0)
        return a_w, a_w * b_w

    if loss_fn is None:
        ranked = make_ranking_mse(stats)

        def loss_fn(Gw, b):
            return ranked(torch.cat([Gw, b[:, None]], dim=1) if has_bias
                          else Gw)

    G = w_flat0
    dual = torch.zeros_like(w_flat0)
    bestG = w_flat0
    bestB = (bias0 if bias0 is not None
             else torch.zeros(c2, dtype=w_flat0.dtype, device=dev))
    bestA = (torch.ones(c2, dtype=torch.float32, device=dev)
             if hp.channel_wise
             else torch.ones((), dtype=torch.float32, device=dev))
    bestLoss = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    rows = []
    for mult, n_iter, dual_factor in rho_segments(hp):
        rho = mult * rho_scale
        chol, _ = torch.linalg.cholesky_ex(make_system(stats, rho, eta,
                                                       hp.mu))
        for _ in range(n_iter):
            w_star, b_star = solve_proximal(chol, stats, rho, eta, G - dual,
                                            W0_ext)
            a_w, G_new = project(w_star + dual)
            dual = w_star - G_new + dual
            loss = loss_fn(G_new, b_star).double()
            better = loss < bestLoss
            bestG = torch.where(better, G_new, bestG)
            bestB = torch.where(better, b_star, bestB)
            bestA = torch.where(better, a_w, bestA)
            bestLoss = torch.where(better, loss, bestLoss)
            # primal residual |w*-G| and dual residual rho*|G-G0|
            rows.append(torch.stack([
                loss, torch.linalg.norm(w_star - G_new).double(),
                (rho * torch.linalg.norm(G_new - G)).double(),
                rho.double()]))
            G = G_new
        dual = dual * dual_factor
    ys = torch.stack(rows).cpu()
    history = {k: ys[:, i] for i, k in enumerate(HISTORY_KEYS)}
    return bestG, bestB, bestA, bestLoss, history


def calibrate_from_stats(stats: GramStats, x_q: torch.Tensor,
                         y_fp: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         att: Optional[torch.Tensor], *, ksize, stride,
                         padding, dilation, qlvl_w: int, has_bias: bool,
                         hp: PTQHyperParams, marks: Optional[list] = None):
    """ADMM calibration given precomputed GramStats; ``marks`` (if given)
    gets a device mark (``utils.tracing.device_mark``) after the ADMM
    loop."""
    w_flat0 = kernel_to_flat(kernel)

    # rho scaling
    y_std = torch.std(y_fp, correction=1)
    w_std = torch.std(w_flat0, correction=1)
    rho_scale = torch.clamp_min((y_fp.numel() * y_std)
                                / (w_flat0.numel() * w_std), 1.0)
    if att is not None:
        rho_scale = rho_scale * att.mean()

    # per-iterate loss: where the spatial extent is small the direct
    # convolution is cheaper than the c1k^2 quadratic form
    S = int(np.prod(y_fp.shape[:-1]))
    loss_fn = None
    if 2 * S < w_flat0.shape[1]:
        def loss_fn(Gw, b):
            out = ops.conv3d(x_q, flat_to_kernel(Gw, kernel.shape),
                             b if has_bias else None, stride, padding,
                             dilation)
            return torch.mean((out - y_fp) ** 2)

    bestG, bestB, alpha_w, best_loss, history = admm_quantize(
        w_flat0, bias, stats, qlvl_w, rho_scale, hp, loss_fn=loss_fn)
    if marks is not None:
        marks.append(device_mark(x_q.device))

    kernel_q = flat_to_kernel(bestG, kernel.shape)
    out_q = ops.conv3d(x_q, kernel_q, bestB if has_bias else None, stride,
                       padding, dilation)
    if hp.bias_corr and has_bias:
        err = y_fp - out_q
        if att is not None:
            w4 = att[..., None]
            delta = ((err * w4).sum(dim=(0, 1, 2, 3))
                     / torch.clamp_min(w4.sum(), 1e-30))
        else:
            delta = err.mean(dim=(0, 1, 2, 3))
        bestB = bestB + delta
        out_q = out_q + delta

    W_ext = torch.cat([bestG, bestB[:, None]], dim=1) if has_bias else bestG
    final_unw = quadratic_mse(stats, W_ext, weighted=False)
    final_att = quadratic_mse(stats, W_ext, weighted=True)
    # scale-free sensitivity: the reported loss over the (same-weighted)
    # target energy, comparable across layers
    yy = stats.yy_att if att is not None else stats.yy_unw
    final_rep = final_att if att is not None else final_unw
    loss_rel = final_rep * stats.numel_y / torch.clamp_min(yy, 1e-30)
    return {
        "kernel": kernel_q,
        "bias": bestB if has_bias else None,
        "alpha_w": alpha_w,
        "alpha_act": None,
        "best_loss": best_loss,
        "loss_unweighted": final_unw,
        "loss_reported": final_rep,
        "loss_relative": loss_rel,
        "out_q": out_q,
        "history": history,
    }


def calibrate_layer(x_q: torch.Tensor, y_fp: torch.Tensor,
                    kernel: torch.Tensor, bias: Optional[torch.Tensor],
                    att: Optional[torch.Tensor], *, ksize, stride, padding,
                    dilation, qlvl_w: int, has_bias: bool, hp: PTQHyperParams,
                    qlvl_act: Optional[int] = None, act_search: int = 0
                    ) -> Dict:
    """Calibrate one conv layer.

    x_q: NDHWC input activation.  With ``qlvl_act`` the optimal activation
    scale is found and the input fake-quantized first; without, the input
    is used as it is.  ``act_search=K`` (with ``qlvl_act``) also searches
    the offset grids k = 0..K (``quant.fake_quant_act_k``).  y_fp: NDHWC
    full-precision target output; kernel/bias: the current FP (BN-folded)
    parameters; att: optional (N, Do, Ho, Wo) attention weights.

    Returns the quantized kernel (DHWIO, values = alpha_w * grid), bias,
    alpha_w, alpha_act (None without ``qlvl_act``), the layer's quantized
    output, the best unweighted loss, the final reported layer loss
    (attention-weighted when att is given), the ADMM history, ``act_k``
    (the chosen offset as an int32 0-d tensor, 0 without a search) and
    ``seconds``: {"gram", "admm", "rest"} of this call (the activation
    projection counts to "gram").
    """
    marks = [device_mark(x_q.device)]
    alpha_act = None
    act_k = torch.zeros((), dtype=torch.int32, device=x_q.device)
    if qlvl_act is not None and act_search:
        # offset-grid search (quant.fake_quant_act_k): candidate grids
        # shift k of the qlvl_act levels below zero (k = 0 is the unsigned
        # grid); the k whose jointly optimal scale reconstructs the input
        # best wins, the smallest k on a tie.  The errors are summed in
        # float64: JAX's float32 sums can misrank near-ties.
        delta = 1.0 / (qlvl_act - 1)
        errs, alphas = [], []
        for k in range(min(int(act_search), qlvl_act - 1) + 1):
            lo = -k * delta
            a_k, b_k = project_by_iter(x_q, qlvl_act, lo, lo + 1.0)
            d = (x_q - a_k * b_k).double()
            errs.append((d * d).sum())
            alphas.append(a_k)
        best = torch.argmin(torch.stack(errs))
        act_k = best.to(torch.int32)
        alpha_act = torch.stack(alphas)[best]
        x_q = fake_quant_act_k(x_q, alpha_act, qlvl_act, act_k)
    elif qlvl_act is not None:
        alpha_act, b_act = project_by_iter(x_q, qlvl_act, 0.0, 1.0)
        x_q = alpha_act * b_act
    stats = compute_gram_stats(x_q, y_fp, att, ksize, stride, padding,
                               dilation, has_bias=has_bias)
    marks.append(device_mark(x_q.device))
    res = calibrate_from_stats(stats, x_q, y_fp, kernel, bias, att,
                               ksize=ksize, stride=stride, padding=padding,
                               dilation=dilation, qlvl_w=qlvl_w,
                               has_bias=has_bias, hp=hp, marks=marks)
    marks.append(device_mark(x_q.device))
    res["seconds"] = {k: device_seconds(a, b) for k, a, b in
                      zip(("gram", "admm", "rest"), marks, marks[1:])}
    return {**res, "alpha_act": alpha_act, "act_k": act_k}
