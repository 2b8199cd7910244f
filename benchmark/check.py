"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same seed.

The reference (``benchmark/reference/``) works out everything again from
the generated rows: each field's slot by the frozen hash rule, the
table's V by the frozen initialisation, epoch 0's batch order with its
count pushes, the set-up's replayed epochs whole, and the first
``followed`` steps of the window's first epoch, each in its epoch's
order. The program's side is what its timed path produced: each step's
objective, and the table rows the followed steps touched, read before,
after the first and after the last of them.

Three numbers, each a relative gap:

- ``loss_gap``: the largest over the steps of |objv - ref| / ref;
- ``grad_gap``: the first followed step's gradient as the optimizer got
  it, worked out from its state (sqrt_g for w, Vg for V: g^2 = after^2 -
  before^2), by the worst leaf: the gap between the two norms over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for the parameters' change over the followed
  steps, leaving out a leaf whose reference gradient is under a
  thousandth of the median leaf's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import batches as ref_batches
from .reference.fm import Trainer
from .reference.hashing import field_slots

HYPER = ("l1", "l2", "lr", "lr_beta", "V_l2", "V_lr", "V_lr_beta",
         "V_threshold", "l1_shrk", "V_init_scale")
LEAVES = ("w", "V")
EXCLUDE_BELOW = 1e-3


def token_slots(rows: Dict[str, np.ndarray], capacity: int,
                device: str) -> torch.Tensor:
    """int64 [n, fields]: each field's slot by the frozen hash rule, -1
    where the field is empty. Each distinct value of a field is hashed
    once."""
    vals = np.concatenate([rows["ints"], rows["cats"]], axis=1)
    ni = rows["ints"].shape[1]
    out = torch.empty(vals.shape, dtype=torch.int64, device=device)
    for g in range(vals.shape[1]):
        col = torch.from_numpy(vals[:, g]).to(device)
        uniq, inv = torch.unique(col, return_inverse=True)
        s = field_slots(uniq.cpu().numpy(), g, g >= ni, capacity)
        out[:, g] = torch.from_numpy(s).to(device)[inv]
    empty = torch.from_numpy(rows["empty"]).to(device)
    return out.masked_fill(empty, -1)


def reference(rows: Dict[str, np.ndarray], conf: dict, seed: int,
              setup_epochs: int, followed: int, device: str) -> dict:
    """The reference's objectives over the ``setup_epochs`` epochs of
    set-up and the followed steps of the next, the first followed step's
    gradient norms and the parameters' change norms over the followed
    steps."""
    n = len(rows["labels"])
    cap = int(conf["hash_capacity"])
    tok = token_slots(rows, cap, device)
    labels = torch.from_numpy(rows["labels"]).to(device)
    tr = Trainer(tok, labels, {k: conf[k] for k in HYPER},
                 int(conf["V_dim"]), int(seed) & 0xFFFFFFFF)
    shuffle = int(conf["shuffle"])
    bs = ref_batches.epoch0_batches(n, int(conf["batch_size"]), shuffle)
    bs = [torch.from_numpy(b).to(device) for b in bs]
    objv = [tr.step(b, count_push=True) for b in bs]
    for epoch in range(1, setup_epochs):
        objv += [tr.step(bs[i], count_push=False)
                 for i in ref_batches.replay_order(len(bs), epoch, shuffle)]
    order = ref_batches.replay_order(len(bs), setup_epochs,
                                     shuffle)[:followed]
    union = torch.unique(torch.cat([tr.batch_slots(bs[i]) for i in order]))
    w0, V0 = tr.w[union].clone(), tr.V[union].clone()
    grads: Dict[str, torch.Tensor] = {}
    for j, i in enumerate(order):
        objv.append(tr.step(bs[i], count_push=False,
                            grads=grads if j == 0 else None))
    return {"objv": objv,
            "grad": {k: float(torch.linalg.vector_norm(grads[k]))
                     for k in LEAVES},
            "change": {"w": float(torch.linalg.vector_norm(
                tr.w[union] - w0)),
                "V": float(torch.linalg.vector_norm(tr.V[union] - V0))}}


def program(rec: dict) -> dict:
    """The same numbers from what the program's recorder read."""
    b, a = rec["first_before"], rec["first_after"]
    g2 = {"w": np.sum(a["sg"] ** 2 - b["sg"] ** 2),
          "V": np.sum(a["Vg"] ** 2 - b["Vg"] ** 2)}
    before, after = rec["before"], rec["after"]
    return {"objv": rec["objv"],
            "grad": {k: float(np.sqrt(max(v, 0.0))) for k, v in g2.items()},
            "change": {k: float(np.linalg.norm(after[k] - before[k]))
                       for k in LEAVES}}


def _leaf_gap(p: Dict[str, float], r: Dict[str, float], keep) -> float:
    med = float(np.median([r[k] for k in LEAVES]))
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    po, ro = np.asarray(prog["objv"]), np.asarray(ref["objv"])
    if po.shape != ro.shape:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "change_gap": float("inf")}
    med = float(np.median([ref["grad"][k] for k in LEAVES]))
    moved = [k for k in LEAVES if ref["grad"][k] >= EXCLUDE_BELOW * med]
    return {"loss_gap": float(np.max(np.abs(po - ro) / np.abs(ro))),
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], LEAVES),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moved)}


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, value, limit)]): every value finite and within
    its limit."""
    rows = [(k, values[k], float(limits[k])) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
