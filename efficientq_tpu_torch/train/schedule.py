"""Optimizer and learning-rate schedule: Adam with poly decay and warmup.

Counterpart of the JAX package's ``train/schedule.py`` (the reference's
``train_seg.py:97-112``): poly decay with exponent 0.9 over the run's
optimizer steps, times a warmup factor over the first epoch's steps (5
epochs when fine-tuning from a pretrain).  The optimizer is
``torch.optim.Adam`` in the order of the JAX package's optax chain: the
gradients value-clipped at 1 (``clip_grad_value_``), then ``weight_decay *
p`` added (Adam's own ``weight_decay``), then Adam (b1 0.9, b2 0.999, eps
1e-8) at the learning rate ``schedule(k)`` for 0-based step k, which the
caller writes into the optimizer's param groups before each step.
"""
from __future__ import annotations

import math

import torch


def poly_warmup_schedule(base_lr: float, total_iters: int,
                         warmup_iters: int, exponent: float = 0.9,
                         warmup: str = "linear"):
    """lr(step) = base * max(1 - step/total, 0)^0.9 * warmup_factor(step),
    with the warmup factor 'linear' min(1, (step+1)/period) or
    'exponential' 1 - exp(-(step+1)/period)."""
    def schedule(step):
        frac = max(1.0 - step / max(total_iters, 1), 0.0) ** exponent
        if warmup == "exponential":
            warm = 1.0 - math.exp(-(step + 1) / max(warmup_iters, 1))
        else:
            warm = min(1.0, (step + 1) / max(warmup_iters, 1))
        return base_lr * frac * warm

    return schedule


def make_optimizer(params, base_lr: float, total_iters: int,
                   warmup_iters: int, weight_decay: float = 0.0):
    """(torch.optim.Adam over ``params``, schedule)."""
    opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    return opt, poly_warmup_schedule(base_lr, total_iters, warmup_iters)
