"""Training losses (PyTorch).

Counterpart of the JAX package's ``train/losses.py`` (the reference's
``src/utils/losses.py``): the eight criteria of ``LOSS_REGISTRY``,

  ce | focal | dice | hybrid(ce+dice) | focalplusdice | bce | bdice |
  bhybrid(bce+bdice)

in the same operations.  Logits come in reference layout (N, C, D, H, W);
integer targets (N, D, H, W) for the softmax family, channel targets
(N, C, D, H, W) for the sigmoid (multi-label) family.
``multi_output_loss`` applies the deep-supervision head weights.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

EPS = 1e-6


def one_hot(label: torch.Tensor, n_class: int, axis: int = 1) -> torch.Tensor:
    return torch.stack([(label == i) for i in range(n_class)],
                       dim=axis).float()


def cross_entropy(logits, target):
    """nn.CrossEntropyLoss (mean over voxels)."""
    logp = torch.log_softmax(logits, dim=1)
    t = one_hot(target, logits.shape[1])
    return -(t * logp).sum(dim=1).mean()


def focal_loss(logits, target, gamma: float = 2.0):
    """(1-p)^gamma-damped NLL, summed over voxels, divided by the number of
    targets."""
    logp = torch.log_softmax(logits, dim=1)
    logp = (1.0 - torch.exp(logp)) ** gamma * logp
    t = one_hot(target, logits.shape[1])
    return -(t * logp).sum() / target.numel()


def general_dice_loss(logits, target, weight=None, power: int = 2,
                      ignore_bkg: bool = True):
    """Softmax multi-class Dice; ``weight="adaptive"`` gives the class
    weights 1/max((sum target_c)^power, 25)."""
    n_class = logits.shape[1]
    probs = torch.softmax(logits, dim=1)
    t = one_hot(target, n_class)
    if weight == "adaptive":
        w = 1.0 / torch.clamp_min(t.sum(dim=(0, 2, 3, 4)) ** power, 25.0)
    elif weight is None:
        w = torch.ones(n_class, dtype=torch.float32, device=logits.device)
    else:
        w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
    if ignore_bkg:
        w = torch.cat([w.new_zeros(1), w[1:]])
    inter = ((probs * t).sum(dim=(2, 3, 4)) * w).sum(dim=1)
    union = ((probs + t).sum(dim=(2, 3, 4)) * w).sum(dim=1)
    loss = 1.0 - (2.0 * inter + EPS) / (union + EPS)
    return loss.mean()


def bce_with_logits(logits, target):
    """Plain mean sigmoid BCE, in the JAX version's stable form (its
    ``maximum(l, 0)``, gradient 0.5 at l = 0)."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return (torch.maximum(logits, zero) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def multilabel_dice_loss(logits, target, weight=None):
    """Sigmoid per-channel Dice, summed over (n, c) with weights normalized
    to sum to C, divided by n."""
    n, c = logits.shape[:2]
    if weight is None:
        w = torch.ones(c, dtype=torch.float32, device=logits.device)
    else:
        w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
    w = w / w.sum() * c
    pred = torch.sigmoid(logits)
    inter = (pred * target).sum(dim=(2, 3, 4))
    sums = target.sum(dim=(2, 3, 4)) + pred.sum(dim=(2, 3, 4))
    d = (2.0 * inter + EPS) / (sums + EPS)
    return ((1.0 - d) * w[None, :]).sum() / n


def hybrid(l1: Callable, l2: Callable, w=(1.0, 1.0)) -> Callable:
    def f(logits, target):
        return w[0] * l1(logits, target) + w[1] * l2(logits, target)
    return f


LOSS_REGISTRY = {
    "ce": cross_entropy,
    "focal": focal_loss,
    "dice": general_dice_loss,
    "hybrid": hybrid(cross_entropy, general_dice_loss),
    "focalplusdice": hybrid(focal_loss, general_dice_loss),
    "bce": bce_with_logits,
    "bdice": multilabel_dice_loss,
    "bhybrid": hybrid(bce_with_logits, multilabel_dice_loss),
}


def get_loss(name: str) -> Callable:
    name = name.lower()
    if name not in LOSS_REGISTRY:
        raise ValueError(f"Unknown loss type: {name}")
    return LOSS_REGISTRY[name]


def head_loss_weights(num_mo: int) -> torch.Tensor:
    """Deep-supervision weights 1/2^i (deepest head least), heads beyond the
    last 3 zeroed, normalized (train_seg.py:114-117)."""
    w = np.array([1 / 2 ** i for i in range(num_mo, 0, -1)])
    for i in range(num_mo - 3):
        w[i] = 0
    w = w / w.sum()
    return torch.tensor(w, dtype=torch.float32)


def multi_output_loss(loss_fn: Callable, head_weights: torch.Tensor,
                      outputs: torch.Tensor, target: torch.Tensor):
    """Weighted sum over stacked head outputs (M, N, C, D, H, W).  Returns
    (total, per-head losses)."""
    arr = torch.stack([loss_fn(outputs[i], target)
                       for i in range(outputs.shape[0])])
    if outputs.shape[0] == 1:
        return arr[0], arr
    assert head_weights.shape[0] == outputs.shape[0], (
        f"{head_weights.shape[0]} head weights for {outputs.shape[0]} heads")
    return (arr * head_weights.to(arr.device)).sum(), arr
