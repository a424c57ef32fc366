"""The comparison that decides ``correct``: each served hard prediction
against the plain reference's logits of the same volume.

A served decision is the class a voxel gets (argmax), or whether each
class is on (multi-label, logit >= 0).  Its gap is how far the
reference's logit lies on the other side: the reference's best logit less
that of the served class, or the reference logit's distance below (above)
0 where the served class is on (off).  The numbers:

- ``max_gap``: the widest gap over every decision of the compared
  volumes, in logits;
- ``disagree_share``: the share of those decisions whose gap is above 0.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def hard(logits: torch.Tensor, multilabel: bool) -> torch.Tensor:
    """The hard prediction of (C, D, H, W) logits in the served layout:
    (D, H, W, C) per-class 0/1, or (D, H, W) class ids."""
    if multilabel:
        return (logits >= 0).to(torch.uint8).permute(1, 2, 3, 0)
    return torch.argmax(logits, dim=0).to(torch.uint8)


def gaps(served: torch.Tensor, ref: torch.Tensor,
         multilabel: bool) -> torch.Tensor:
    """Each decision's gap (see the module docstring), float32."""
    if multilabel:
        on = served.permute(3, 0, 1, 2).bool()
        return torch.where(on, -ref, ref).clamp_min(0.0)
    best = ref.max(dim=0).values
    got = torch.gather(ref, 0, served.long()[None])[0]
    return best - got


def numbers(served: torch.Tensor, ref: torch.Tensor,
            multilabel: bool) -> Dict[str, float]:
    g = gaps(served, ref, multilabel)
    return {"max_gap": float(g.max()),
            "disagree_share": float((g > 0).float().mean())}


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number read and within its limit, {name: {value, limit}});
    a number that nothing gave (no volume compared) is None and fails."""
    checks = {k: {"value": readings.get(k), "limit": limits[k]}
              for k in limits}
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values()), checks

