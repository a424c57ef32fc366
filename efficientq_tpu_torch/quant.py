"""Quantization math core (PyTorch).

Counterpart of the JAX package's ``quant.py``: the uniform fake-quantizer,
integer weight packing, the alternating scale search ``project_by_iter``
(per tensor and per row) and its float64 NumPy oracle.

Every divisor is made a tensor on the operand's device before dividing: on
a CUDA tensor PyTorch turns ``x / python_float`` into ``x * (1 / float)``,
which rounds differently from the true division the JAX reference does.

A bfloat16 activation is quantized in float32: JAX promotes
``bf16_array / f32_alpha`` to float32, where PyTorch would keep bfloat16
(a 0-d alpha does not raise the dtype of a dimensioned tensor) and so
round the quotient, changing codes.

The clips that gradients pass through (``discretize``, the tensor-``k``
branch of ``fake_quant_act_k``) are ``minimum(maximum(x, lo), hi)`` with
tensor bounds: each bound passes half the gradient at a tie, as
``jnp.clip`` does (``torch.clamp`` passes all of it).  Ties are common in
QAT: after ``run_ptq`` every extreme weight code sits exactly on a bound.
"""
from __future__ import annotations

import numpy as np
import torch


class _SteRound(torch.autograd.Function):
    """Round half to even, with a straight-through gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _SteRound.apply(x)


def _promoted(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 if it is a half-width float (JAX's promotion
    against a float32 alpha), else unchanged."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 0-d (or per-channel) tensor on ``like``'s device.
    A Python number is filled in on the device: copying it from the host
    would wait for the device's queue to drain."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=torch.float32, device=like.device)
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def clip(x, lo, hi):
    """``jnp.clip``: the value of ``torch.clamp``, and half the gradient at
    each bound on a tie.  ``lo`` and ``hi`` are tensors or numbers.  Where
    no gradient can flow (number bounds, ``x`` without one: the
    calibration's projection loop, serving) it is one ``torch.clamp``,
    with the same values."""
    numbers = not isinstance(lo, torch.Tensor) and not isinstance(
        hi, torch.Tensor)
    if numbers and not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, _bound(lo, x)), _bound(hi, x))


def _bound(v, like):
    """A number as a 0-d CPU tensor: an elementwise op on a CUDA tensor
    takes it as a scalar, with no fill launched on the device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=like.dtype)


def discretize(var, num_lvl, lo, hi):
    """Uniform fake-quantization of ``var`` onto ``num_lvl`` levels in
    [lo, hi]; the gradient is straight-through.  Same op order as the JAX
    version: clip, subtract lo, divide by the step, round, rescale."""
    delta = _scalar((hi - lo) / (num_lvl - 1), var)
    lo_t = _scalar(lo, var)
    var = clip(var, lo, hi)
    q = ste_round((var - lo_t) / delta)
    return q * delta + lo_t


def fake_quant_weight(w, alpha_w, num_lvl):
    """Symmetric weight fake-quant: clip(w/a, -1, 1) on the grid, times a."""
    a = _scalar(alpha_w, w)
    return discretize(w / a, num_lvl, -1.0, 1.0) * a


def fake_quant_act(x, alpha_act, num_lvl):
    """Unsigned activation fake-quant: clip(x/a, 0, 1) on the grid, times a."""
    a = _scalar(alpha_act, x)
    return discretize(_promoted(x) / a, num_lvl, 0.0, 1.0) * a


def fake_quant_act_k(x, alpha_act, num_lvl, k):
    """Offset activation fake-quant: the uniform grid
    ``(i - k)/(num_lvl-1) * alpha_act``, i in 0..num_lvl-1 (k levels below
    zero).  Zero stays on the grid, so the int8 conv of the codes ``q - k``
    needs no correction term; ``k = 0`` is :func:`fake_quant_act` bit for
    bit.

    As in the JAX version, a Python-int ``k`` (a shift baked into a node's
    attributes at deployment) puts the grid's ends in float64 before they
    meet the float32 data, and a tensor ``k`` (a calibrated parameter)
    computes them in float32."""
    a = _scalar(alpha_act, x)
    if isinstance(k, torch.Tensor):
        one = torch.ones((), dtype=torch.float32, device=x.device)
        lo = -k.to(device=x.device, dtype=torch.float32) * _scalar(
            1.0 / (num_lvl - 1), x)
        hi = lo + one
        delta = (hi - lo) / _scalar(float(num_lvl - 1), x)
        v = clip(_promoted(x) / a, lo, hi)
        q = ste_round((v - lo) / delta)
        return (q * delta + lo) * a
    lo = -int(k) * (1.0 / (num_lvl - 1))
    return discretize(_promoted(x) / a, num_lvl, lo, lo + 1.0) * a


def act_codes(x, alpha_act, num_lvl, k: int = 0):
    """The int8 activation codes ``round(clip(x/a, 0, 1) * (n-1))`` that an
    int8 conv consumes (the JAX ``qconv3x3_int8_ndhwc`` prologue); with an
    offset grid ``k`` the signed codes ``clip(round(x/a * (n-1)), -k,
    n-1-k)`` (the JAX package's int8 conv of an ``act_k`` layer)."""
    a = _scalar(alpha_act, x)
    if k:
        return torch.clamp(torch.round(_promoted(x) / a * (num_lvl - 1)),
                           -k, num_lvl - 1 - k).to(torch.int8)
    return torch.round(torch.clamp(_promoted(x) / a, 0.0, 1.0)
                       * (num_lvl - 1)).to(torch.int8)


def _project(v, num_lvl, lo, hi, tol, max_iter, block, rows):
    """The alternating (scale, code) search on float32 ``v``: one scale, or
    one per row of a 2-D ``v`` (each row converging on its own).

    The loop of the JAX version stops when |a - a_prev| <= tol or after
    ``max_iter`` steps.  Here each scale carries a "done" flag on the
    device that freezes it once that test holds, the steps run in blocks
    of ``block`` and the host reads the flags once per block: the same
    result as stepping one at a time, with one host sync per block instead
    of one per step."""
    if max_iter is None:
        max_iter = int(num_lvl) * 100
    if rows:
        def dot(p, q):
            return (p * q).sum(dim=-1, keepdim=True)
        a = v.abs().mean(dim=-1, keepdim=True)
    else:
        def dot(p, q):
            return (p * q).sum()
        a = v.abs().mean()
    a_prev = torch.full_like(a, -999.0)
    done = ~((a - a_prev).abs() > tol)
    steps = 0
    while steps < max_iter:
        for _ in range(min(block, max_iter - steps)):
            b = discretize(v / a, num_lvl, lo, hi)
            den = dot(b, b)
            a_new = torch.where(den > 0, dot(b, v) / den, a)
            a_prev = torch.where(done, a_prev, a)
            a = torch.where(done, a, a_new)
            done = done | ~((a - a_prev).abs() > tol)
            steps += 1
        if bool(done.all()):
            break
    return a, discretize(v / a, num_lvl, lo, hi)


def project_by_iter(var, num_lvl, lo=-1.0, hi=1.0, tol=1e-5, max_iter=None,
                    block=8):
    """Jointly optimal (scale a, code b) for ``var ~= a * b`` with b on the
    uniform ``num_lvl``-level grid in [lo, hi], by alternating minimization:
    b = discretize(var/a), a = <b,var>/<b,b> (kept when <b,b> = 0), from
    a = mean|var|, until |a - a_prev| <= tol or ``num_lvl*100`` steps.

    Returns (a, b): a float32 0-d scale and the codes in ``var``'s dtype.
    ``block``: steps between host reads of the convergence flag (1 steps
    one at a time; the result is the same)."""
    a, b = _project(var.float(), num_lvl, lo, hi, tol, max_iter, block,
                    rows=False)
    return a, b.to(var.dtype)


def project_by_iter_rows(var2d, num_lvl, lo=-1.0, hi=1.0, tol=1e-5,
                         max_iter=None, block=8):
    """Per-row :func:`project_by_iter`: (a (R,), b (R, K)) with
    ``var2d ~= a[:, None] * b``, each row converging on its own (the
    per-output-channel weight scale, ``channel_wise``)."""
    a, b = _project(var2d.float(), num_lvl, lo, hi, tol, max_iter, block,
                    rows=True)
    return a[:, 0], b.to(var2d.dtype)


def pack_int_weight(qweight, alpha_w, num_lvl):
    """Fake-quantized weight (values = alpha_w * grid) -> integer codes
    ``round((w/alpha + 1) / delta)`` in [0, num_lvl-1]; uint8 for <= 256
    levels, int32 otherwise.  NumPy in and out, torch layout (O, I, D, H, W);
    ``alpha_w`` is a scalar or a per-output-channel vector."""
    w = np.asarray(qweight)
    b = w / _alpha_bcast(alpha_w, w.ndim)
    delta = 2.0 / (num_lvl - 1)
    w_int = np.round((b + 1.0) / delta)
    return w_int.astype(np.uint8 if num_lvl <= 256 else np.int32)


def _alpha_bcast(alpha_w, ndim):
    a = np.asarray(alpha_w, np.float64)
    if a.ndim == 0:
        return float(a)
    return a.reshape((-1,) + (1,) * (ndim - 1))


def unpack_int_weight(w_int, alpha_w, num_lvl, dtype=np.float32):
    """Inverse of :func:`pack_int_weight` (NumPy)."""
    delta = 2.0 / (num_lvl - 1)
    b = np.asarray(w_int).astype(dtype) * delta - 1.0
    return (_alpha_bcast(alpha_w, b.ndim) * b).astype(dtype)


def project_by_iter_np(var, num_lvl, lo=-1.0, hi=1.0, tol=1e-5):
    """Float64 NumPy oracle of the alternating (scale, code) search:
    b = discretize(var/a), a = <b,var>/<b,b> until |a - a_prev| <= tol or
    ``num_lvl*100`` iterations.  Returns (a, b)."""
    v = np.asarray(var, dtype=np.float64)
    max_iter = int(num_lvl) * 100
    a = float(np.abs(v).mean())
    a_prev = -999.0
    c = 0
    delta = (hi - lo) / (num_lvl - 1)

    def disc(x):
        return np.round((np.clip(x, lo, hi) - lo) / delta) * delta + lo

    while abs(a - a_prev) > tol and c < max_iter:
        b = disc(v / a)
        a_prev = a
        den = float((b * b).sum())
        if den > 0:
            a = float((b * v).sum()) / den
        c += 1
    b = disc(v / a)
    return a, b.astype(var.dtype if hasattr(var, "dtype") else np.float32)
