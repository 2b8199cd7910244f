"""The plain reference trainer: the factorization machine, its logistic
objective and gradients straight from the formulas (the reference's
fm_loss.h), FTRL-proximal on w and AdaGrad on V (sgd_updater.cc), in
float64 plain PyTorch over the rows the data touches.

    pred = sum_t w[t] + 0.5 * sum_j ((sum_t Vm[t, j])^2 - sum_t Vm[t, j]^2)
    clamped to +-20, Vm = V * (live & w != 0), binary features
    objv = sum_rows log(1 + exp(-y pred)),  p = -y / (1 + exp(y pred))
    gw[u] = sum of p over the tokens of slot u
    gV[u] = (sum_t p XV - gw[u] Vm[u]) * mask[u]

The epoch-0 steps first push each slot's token count (``cnt``) and
activate embeddings whose w is nonzero and whose count passed
``V_threshold``; every step then pulls, trains and pushes the batch's
distinct slots: FTRL on w with g = gw + l2 w, the activation again,
AdaGrad on the rows whose embedding was pulled.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .init import init_V

PRED_CLAMP = 20.0
F64 = torch.float64


class Trainer:
    """The table restricted to the slots the data holds (``universe``,
    sorted), every leaf float64."""

    def __init__(self, tok: torch.Tensor, labels: torch.Tensor, hyper: dict,
                 k: int, seed: int):
        """``tok`` int64 [rows, fields]: each field's slot, -1 where
        empty; ``labels`` 0/1 [rows]."""
        dev = tok.device
        valid = tok >= 0
        self.universe = torch.unique(tok[valid])
        self.tok = torch.where(
            valid, torch.searchsorted(self.universe, tok.clamp(min=0)),
            torch.full_like(tok, -1))
        self.y = torch.where(labels > 0, 1.0, -1.0).to(F64)
        self.h = {key: float(v) for key, v in hyper.items()}
        n = self.universe.numel()
        self.k = k
        self.w = torch.zeros(n, dtype=F64, device=dev)
        self.z = torch.zeros_like(self.w)
        self.sg = torch.zeros_like(self.w)
        self.cnt = torch.zeros_like(self.w)
        self.live = torch.zeros(n, dtype=torch.bool, device=dev)
        self.V = init_V(self.universe, k, seed,
                        self.h["V_init_scale"]).to(F64)
        self.Vg = torch.zeros_like(self.V)

    def batch_slots(self, rows: torch.Tensor) -> torch.Tensor:
        """Universe positions of a batch's distinct slots."""
        t = self.tok[rows]
        return torch.unique(t[t >= 0])

    def step(self, rows: torch.Tensor, count_push: bool,
             grads: Optional[Dict[str, torch.Tensor]] = None) -> float:
        """One training step on the batch ``rows``; returns its objective.
        ``grads`` receives the gradient as the optimizer gets it: ``w``
        over the batch's slots, ``V`` over the rows whose embedding was
        pulled."""
        h = self.h
        t = self.tok[rows]
        valid = t >= 0
        tt = t[valid]
        trow = torch.arange(t.shape[0], device=t.device)[:, None] \
            .expand_as(t)[valid]
        ub, inv = torch.unique(tt, return_inverse=True)
        if count_push:
            self.cnt.index_add_(0, tt, torch.ones_like(tt, dtype=F64))
            self.live[ub] |= (self.w[ub] != 0) \
                & (self.cnt[ub] > h["V_threshold"])
        w, V = self.w[ub], self.V[ub]
        vm = (self.live[ub] & (w != 0)) if h["l1_shrk"] \
            else self.live[ub]
        Vm = V * vm[:, None]
        B = t.shape[0]
        lin = torch.zeros(B, dtype=F64, device=t.device).index_add_(
            0, trow, w[inv])
        tV = Vm[inv]
        XV = torch.zeros(B, self.k, dtype=F64, device=t.device).index_add_(
            0, trow, tV)
        XXVV = torch.zeros_like(XV).index_add_(0, trow, tV * tV)
        del tV
        pred = (lin + 0.5 * (XV * XV - XXVV).sum(1)).clamp(-PRED_CLAMP,
                                                          PRED_CLAMP)
        y = self.y[rows]
        objv = float(torch.log1p(torch.exp(-y * pred)).sum())
        p = -y / (1.0 + torch.exp(y * pred))
        gw = torch.zeros_like(w).index_add_(0, inv, p[trow])
        t1 = torch.zeros_like(V).index_add_(0, inv, (p[:, None] * XV)[trow])
        gV = (t1 - gw[:, None] * Vm) * vm[:, None]
        # FTRL-proximal on w
        z, sg = self.z[ub], self.sg[ub]
        g = gw + h["l2"] * w
        sg_new = torch.sqrt(sg * sg + g * g)
        z_new = z - (g - (sg_new - sg) / h["lr"] * w)
        eta = (h["lr_beta"] + sg_new) / h["lr"]
        w_new = torch.where(z_new.abs() <= h["l1"], torch.zeros_like(z_new),
                            (z_new - torch.sign(z_new) * h["l1"]) / eta)
        self.w[ub], self.z[ub], self.sg[ub] = w_new, z_new, sg_new
        self.live[ub] |= (w_new != 0) & (self.cnt[ub] > h["V_threshold"])
        # AdaGrad on the pulled embeddings
        gv = gV + h["V_l2"] * V
        Vg = self.Vg[ub]
        Vg_new = torch.sqrt(Vg * Vg + gv * gv)
        V_new = V - h["V_lr"] / (Vg_new + h["V_lr_beta"]) * gv
        m = vm[:, None]
        self.V[ub] = torch.where(m, V_new, V)
        self.Vg[ub] = torch.where(m, Vg_new, Vg)
        if grads is not None:
            grads["w"] = g
            grads["V"] = gv[vm]
        return objv
