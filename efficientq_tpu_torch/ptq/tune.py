"""Activation-range tuning (``--tune_act``) and the validated tail clip
sweep (``--tail_alpha_sweep``).

Counterpart of the JAX package's ``ptq/tune.py`` (the reference's
``tune_activation_range``, ``src/ptqer.py:238-272``).  The JAX version
steps optax's ``adam(lr)``; this one steps ``torch.optim.Adam`` at the
same defaults (betas 0.9 and 0.999, eps 1e-8), the same update rule
rounded in another order.  Gradients reach ``alpha_act`` through the
fake-quantizer's straight-through round (``quant.ste_round``).  The
forward runs inside ``ops.exact_f32()``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import nnir, ops
from ..nnir import Graph


def _with_alphas(params, state, alphas):
    p2 = {k: dict(v) for k, v in params.items()}
    for name, a in alphas.items():
        p2[name]["alpha_act"] = a
    return {"params": p2, "state": state}


def tune_activation_range(graph: Graph, variables, calib_x, output_fp,
                          max_iter: int = 1000, lr: float = 5e-4,
                          score_fn=None, score_every: int = 50
                          ) -> Tuple[Dict, List[float], Dict]:
    """Optimize every activation-quantized conv's ``alpha_act`` jointly by
    Adam on the whole-net reconstruction MSE against ``output_fp``, in
    'quantized' mode (the stored kernels are post-PTQ).  ``calib_x``
    (NDHWC) and ``output_fp`` go to the variables' device.

    ``score_fn(variables) -> float`` (higher is better): scored at
    iteration 0, every ``score_every`` iterations and at the last; the
    best-scoring alphas are returned instead of the last, so tuning never
    does worse than not tuning by the score's judgment.

    Returns (variables', loss history, info); ``info`` holds ``scores``
    [(iter, score), ...], ``best_iter`` and ``best_score`` when scoring is
    on, else it is empty."""
    params = {k: dict(v) for k, v in variables["params"].items()}
    state = variables.get("state", {})
    act_nodes = [n.name for n in graph.qconv_nodes() if n.attrs["qcfg"].q_act]
    device = params[act_nodes[0]]["alpha_act"].device
    calib_x = torch.as_tensor(calib_x).to(device)
    output_fp = torch.as_tensor(output_fp).to(device)
    alphas = {name: params[name]["alpha_act"].detach().clone()
              .requires_grad_(True) for name in act_nodes}
    opt = torch.optim.Adam(list(alphas.values()), lr=lr)

    def snapshot():
        return {k: v.detach().clone() for k, v in alphas.items()}

    info: Dict = {}
    if score_fn is not None:
        best_alphas, best_iter = snapshot(), 0
        best_score = float(score_fn(_with_alphas(params, state,
                                                 best_alphas)))
        info["scores"] = [(0, best_score)]

    losses = []
    with ops.exact_f32():
        for it in range(1, max_iter + 1):
            opt.zero_grad(set_to_none=True)
            out = nnir.apply(graph, _with_alphas(params, state, alphas),
                             calib_x, mode="quantized")
            loss = torch.mean((out - output_fp) ** 2)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if score_fn is not None and (it % score_every == 0
                                         or it == max_iter):
                cur = snapshot()
                s = float(score_fn(_with_alphas(params, state, cur)))
                info["scores"].append((it, s))
                if s > best_score:
                    best_score, best_alphas, best_iter = s, cur, it

    final = best_alphas if score_fn is not None else snapshot()
    if score_fn is not None:
        info["best_iter"], info["best_score"] = best_iter, best_score
    return _with_alphas(params, state, final), losses, info


def sweep_tail_alpha(graph: Graph, variables, score_fn,
                     factors=(1.0, 1.3, 1.7, 2.2, 3.0), convs=None):
    """Validated clip-range sweep on the network's tail: multiply the tail
    convs' calibrated ``alpha_act`` (``engine.tail_sensitive_convs`` unless
    ``convs`` names others) by each factor, score each with ``score_fn``
    (quantized dice on the labeled calibration volumes) and keep the best.
    Factor 1.0 returns the variables as they came.

    Returns ``(variables', info)``: ``info`` holds ``scores`` [(factor,
    score), ...], ``best_factor``, ``best_score`` and ``convs``."""
    from .engine import tail_sensitive_convs

    if convs is None:
        convs = tail_sensitive_convs(graph)
    convs = [c for c in convs
             if "alpha_act" in variables["params"].get(c, {})]
    if not convs:
        return variables, {"scores": [], "best_factor": 1.0}

    def with_factor(fac):
        if fac == 1.0:
            return variables
        p2 = {k: dict(v) for k, v in variables["params"].items()}
        for name in convs:
            a = variables["params"][name]["alpha_act"]
            p2[name]["alpha_act"] = a * torch.tensor(
                fac, dtype=torch.float32, device=a.device)
        return {"params": p2, "state": variables.get("state", {})}

    scores = []
    best = (variables, None, 1.0)
    for fac in factors:
        v2 = with_factor(float(fac))
        s = float(score_fn(v2))
        scores.append((float(fac), s))
        if best[1] is None or s > best[1]:
            best = (v2, s, float(fac))
    return best[0], {"scores": scores, "best_factor": best[2],
                     "best_score": best[1], "convs": list(convs)}
