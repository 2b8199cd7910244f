"""Hashing-trick quality study of the port: planted-model AUC against the
hashed table's load factor (counterpart of the root
``tools/collision_study.py``, with its keys).

The reference's distributed SGD keys the model by exact 64-bit feature
id, so distinct features never alias; the hashed store trades that for a
fixed capacity, where distinct ids can share a row for good. This study
makes the trade a number: it trains the Criteo stand-in FM through the
port's converter, reader and learner at ``hash_capacity`` in {2x, 1x,
0.5x, 0.25x} the measured distinct-feature count and reports the best
validation AUC beside the collision fraction
(store.local.collision_stats).

    python -m difacto_tpu_torch.tools.collision_study [--rows N]
        [--data-dir data] [--device cuda|cpu]

Writes one JSON line per capacity after a ``distinct_ids`` line; reuses
``<data-dir>/criteo_*.rec`` when present, else writes the synthetic
Criteo rows itself (:func:`synth_criteo`, the root tools/download.py
generator, copied: nothing is downloaded).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


# --------------------------------------------------- the synthetic data
def _planted_auc(prob: np.ndarray, label: np.ndarray) -> float:
    """AUC of the planted true probabilities against the sampled labels,
    the ceiling any learner on this data approaches."""
    order = np.argsort(prob, kind="stable")
    ranks = np.empty(len(prob))
    ranks[order] = np.arange(1, len(prob) + 1)
    pos = label > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def _write_meta(path: str, meta: dict) -> None:
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {path} ({meta['rows']} rows; planted-model AUC "
          f"{meta['planted_auc']:.4f})")


def _sample_labels(rng, score: np.ndarray) -> tuple:
    prob = 1.0 / (1.0 + np.exp(-score))
    label = (rng.random_sample(len(prob)) < prob).astype(np.int8)
    return prob, label


def synth_criteo(data_dir: str, seed: int = 0, rows: int = 2_000_000,
                 val_fraction: float = 0.1) -> None:
    """Criteo-kaggle stand-in in the reference's criteo tab format
    (label \\t 13 ints \\t 26 categoricals): zipf-skewed token popularity
    (~100k tokens/field), planted per-token linear weights + rank-8
    interactions across 8 of the 26 categorical fields, plus log-scaled
    integer-feature effects. Train and val splits share the planted
    model. The root tools/download.py generator, bit for bit."""
    rng = np.random.RandomState(seed)
    n_tok, k = 100_000, 8
    w_tab = rng.randn(26, n_tok) * 0.20
    v_tab = rng.randn(8, n_tok, k) * 0.16
    w_int = rng.randn(13) * 0.05
    for split, n in (("train", rows), ("val", int(rows * val_fraction))):
        path = os.path.join(data_dir, f"criteo_{split}.txt")
        probs_all, labels_all = [], []
        with open(path, "w") as f:
            for start in range(0, n, 65536):
                b = min(65536, n - start)
                ints = rng.randint(0, 1000, (b, 13))
                toks = (rng.zipf(1.25, (b, 26)) - 1) % n_tok
                score = (np.take_along_axis(w_tab.T, toks, axis=0).sum(1)
                         + (np.log1p(ints) * w_int).sum(1) - 1.3)
                emb = v_tab[np.arange(8)[None, :], toks[:, :8]]  # [b,8,k]
                xv = emb.sum(1)
                score += 0.5 * ((xv ** 2).sum(1) - (emb ** 2).sum((1, 2)))
                prob, label = _sample_labels(rng, score)
                probs_all.append(prob)
                labels_all.append(label)
                cats = np.char.add("c", toks.astype(str))
                cols = np.concatenate([label.astype(str)[:, None],
                                       ints.astype(str), cats], axis=1)
                f.write("\n".join("\t".join(r) for r in cols) + "\n")
        _write_meta(path, {
            "dataset": f"criteo-kaggle {split} (synthetic stand-in)",
            "rows": n, "tokens_per_field": n_tok,
            "planted_auc": _planted_auc(np.concatenate(probs_all),
                                        np.concatenate(labels_all)),
            "seed": seed})


# -------------------------------------------------------------- the study
def ensure_data(data_dir: str, rows: int, batch: int) -> tuple:
    """(train rec, val rec): the synthetic rows converted by the port's
    ``task=convert`` path, made once per ``data_dir``."""
    from ..data.converter import Converter

    train_txt = os.path.join(data_dir, "criteo_train.txt")
    if not os.path.exists(train_txt):
        os.makedirs(data_dir, exist_ok=True)
        synth_criteo(data_dir, rows=rows)
    recs = []
    for split in ("train", "val"):
        txt = os.path.join(data_dir, f"criteo_{split}.txt")
        rec = os.path.join(data_dir, f"criteo_{split}.rec")
        if not os.path.exists(rec):
            conv = Converter()
            conv.init([("data_in", txt), ("data_format", "criteo"),
                       ("data_out", rec), ("data_out_format", "rec"),
                       ("rec_batch_size", str(batch)),
                       ("convert_procs", "1")])
            conv.run()
        recs.append(rec)
    return tuple(recs)


def count_distinct(rec_path: str) -> np.ndarray:
    """All distinct raw feature ids in the file (chunked union)."""
    from ..data.reader import Reader
    uniqs = []
    for blk in Reader(rec_path, "rec", 0, 1):
        uniqs.append(np.unique(blk.index))
        if len(uniqs) >= 16:
            uniqs = [np.unique(np.concatenate(uniqs))]
    return np.unique(np.concatenate(uniqs))


def run_one(train_rec: str, val_rec: str, capacity: int, epochs: int,
            batch: int, device: str = "cuda") -> dict:
    """One hashed FM training run at ``capacity`` rows: its best and
    per-epoch validation AUC and its wall seconds."""
    from ..learners.base import Learner
    ln = Learner.create("sgd", device=device)
    ln.init([("data_in", train_rec), ("data_val", val_rec),
             ("data_format", "rec"), ("loss", "fm"), ("V_dim", "16"),
             ("V_threshold", "25"), ("lr", "0.02"), ("V_lr", "0.02"),
             ("l1", "1e-4"), ("l2", "1e-3"), ("V_l2", "2e-3"),
             ("batch_size", str(batch)), ("shuffle", "1"),
             ("max_num_epochs", str(epochs)),
             ("report_interval", "0"), ("stop_rel_objv", "0"),
             ("stop_val_auc", "-2"), ("V_dtype", "bfloat16"),
             ("hash_capacity", str(capacity))])
    aucs = []
    ln.add_epoch_end_callback(
        lambda e, t, v: aucs.append(v.auc / max(v.nrows, 1.0)))
    t0 = time.perf_counter()
    ln.run()
    return {"val_auc_best": round(max(aucs), 4),
            "val_auc_by_epoch": [round(a, 4) for a in aucs],
            "wall_s": round(time.perf_counter() - t0, 1)}


def main(argv=None) -> int:
    from ..store.local import collision_stats
    ap = argparse.ArgumentParser(
        description="planted-model AUC against the hashed table's load "
                    "factor")
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--mults", default="2,1,0.5,0.25",
                    help="capacity multipliers over the distinct-id count")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    train_rec, val_rec = ensure_data(args.data_dir, args.rows, args.batch)
    ids = count_distinct(train_rec)
    n = len(ids)
    print(json.dumps({"distinct_ids": n, "rows": args.rows}), flush=True)
    for mult in (float(m) for m in args.mults.split(",")):
        cap = int(n * mult)
        stats = collision_stats(ids, cap)
        res = run_one(train_rec, val_rec, cap, args.epochs, args.batch,
                      args.device)
        print(json.dumps({"capacity_mult": mult, **stats, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
