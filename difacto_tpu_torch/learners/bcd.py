"""Block coordinate descent learner, ℓ1 logistic regression (counterpart
of difacto_tpu/learners/bcd.py; the reference's src/bcd/).

The feature axis is cut into blocks by feature-group bits and sampled
occurrence stats; each epoch sweeps the blocks (shuffled), and per block
computes the first-order gradient and the diagonal Hessian on
feature-major data, applies a diagonal-Newton proximal ℓ1 step with a
per-coordinate trust region, and updates the cached predictions with
X·Δw.

- Tiles: the rows are read and localized through data/tile_builder.py;
  each row tile keeps its labels, mask and predictions on the device,
  and its (tile, block) COO slices are built on demand and held in a
  byte-bounded data/tile_store.TileCache (``tile_cache_mb``,
  ``tile_cache_items``), as in the JAX package.
- A block (``_iterate_block``): the train tiles' (g, h) summed on the
  device by losses/logit_delta.delta_grad, fetched to the host in ONE
  copy; the diag-Newton update and trust region (BCDUpdater::UpdateWeight,
  bcd_updater.h:139-159; bcd::Delta, bcd_utils.h:146-163) in numpy
  float64 on the host, as the JAX package does (O(block) elementwise);
  then Δw back to the card and every tile's predictions updated
  (delta_pred_update), training and validation alike (UpdtPred).
- FeaGroupStats' 10% row sampling (bcd_utils.h:92-120) and
  PartitionFeature's reversed-keyspace ranges (bcd_utils.h:65-87) are
  the JAX package's, bit for bit.
- The progress [count, objv, auc, acc] + nnz(w) is evaluated after each
  epoch over every tile, validation included (bcd_learner.cc:265-313),
  on the host from one copy of all tiles' predictions.

Every device sum has a fixed order (logit_delta.py), so two runs on the
card give the same bits. ``mesh_dp > 1`` shards the rows of every tile
over a ``(dp, 1)`` mesh (parallel/mesh.py), as the JAX learner's
shard_map does: a (tile, block) slice is cut into dp row shards, each
shard's (g, h) partial is computed on its own and the partials are
summed in dp order; the prediction update takes the whole slice (each
row's sum is its own, so its bits are the shards'). The multi-host
branches (the DCN allreduce) are ROADMAP.md item 11b.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..base import (FEAID_DTYPE, decode_fea_grp_id, encode_fea_grp_id,
                    reverse_bytes)
from ..config import KWArgs, Param
from ..data.reader import Reader
from ..data.tile_builder import TileBuilder
from ..data.tile_store import TileCache
from ..losses.logit_delta import BlockSlice, delta_grad, delta_pred_update
from ..losses.metrics import accuracy_times_n, auc_times_n_np, logit_objv_np
from ..obs import REGISTRY, trace
from ..ops.batch import bucket
from ..ops.kv import expand_ranges, find_position
from ..utils import manifest as mft
from ..utils import stream
from ..utils.platform import resolve_device
from .base import Learner, register

log = logging.getLogger("difacto_tpu_torch")

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass
class BCDLearnerParam(Param):
    """src/bcd/bcd_param.h:10-51, with the JAX package's defaults."""
    data_in: str = ""
    data_val: str = ""
    data_format: str = "libsvm"
    data_cache: str = ""
    model_out: str = ""
    model_in: str = ""
    loss: str = "fm"  # accepted for parity; BCD always uses logit_delta
    max_num_epochs: int = 20
    block_ratio: float = 4.0
    random_block: int = 1
    num_feature_group_bits: int = 0
    neg_sampling: float = 1.0  # declared but unused in the reference too
    data_chunk_size: int = 1 << 28  # bytes
    seed: int = 0
    tile_cache_items: int = 0
    tile_cache_mb: int = 1024
    mesh_dp: int = 1


@dataclass
class BCDUpdaterParam(Param):
    """src/bcd/bcd_updater.h:20-38."""
    V_dim: int = 0  # linear only (InitWeights CHECK_EQ)
    tail_feature_filter: int = 4
    l1: float = 1.0
    l2: float = 0.01
    lr: float = 0.9


class BCDProgress(NamedTuple):
    """The reference's progress [count, objv, auc, acc]
    (bcd_learner.cc:296-311) + nnz_w; raw sums, not divided."""
    count: float = 0.0
    objv: float = 0.0
    auc: float = 0.0
    acc: float = 0.0
    nnz_w: float = 0.0


def fea_group_stats(blocks, nbits: int, skip: int = 10) -> np.ndarray:
    """Sampled per-group nnz counts (FeaGroupStats, bcd_utils.h:92-120):
    every ``skip``-th row contributes; layout [cnt_0..cnt_{2^b-1},
    sampled_rows, total_rows]."""
    value = np.zeros((1 << nbits) + 2, dtype=np.float64)
    for blk in blocks:
        add_group_stats(value, blk, nbits, skip)
    return value


def add_group_stats(value: np.ndarray, blk, nbits: int,
                    skip: int = 10) -> None:
    """Accumulate one block's sampled stats into ``value`` in place."""
    ngrp = 1 << nbits
    rows = np.arange(0, blk.size, skip)
    counts = np.diff(blk.offset)[rows]
    nnz_idx = expand_ranges(np.asarray(blk.offset[rows]), counts)
    gids = decode_fea_grp_id(blk.index[nnz_idx], nbits)
    np.add.at(value, gids.astype(np.int64), 1)
    value[ngrp] += len(rows)
    value[ngrp + 1] += blk.size


def partition_feature(nbits: int, feagrps: List[Tuple[int, int]]
                      ) -> List[Tuple[int, int]]:
    """PartitionFeature (bcd_utils.h:65-87): per (group, nblk) split the
    group's reversed-keyspace range into nblk even segments."""
    if nbits % 4 != 0:
        raise ValueError("num_feature_group_bits must be 0, 4, 8, ...")
    ranges: List[List[int]] = []
    for gid, nblk in feagrps:
        lo = int(reverse_bytes(encode_fea_grp_id(0, gid, nbits)))
        hi = int(reverse_bytes(encode_fea_grp_id(int(UINT64_MAX) >> nbits,
                                                 gid, nbits)))
        span = hi - lo
        for i in range(nblk):
            b = lo + span * i // nblk
            e = lo + span * (i + 1) // nblk
            if e > b:
                ranges.append([b, e])
    ranges.sort(key=lambda r: r[0])
    for i in range(1, len(ranges)):
        if ranges[i - 1][1] < ranges[i][0]:
            ranges[i - 1][1] += 1  # close 1-gaps (bcd_utils.h:83-86)
    return [(b, e) for b, e in ranges]


@register("bcd")
class BCDLearner(Learner):
    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = device
        self.param: Optional[BCDLearnerParam] = None
        self.epoch_end_callbacks: List[Callable[[int, BCDProgress], None]] \
            = []

    # ----------------------------------------------------------- init
    def init(self, kwargs: KWArgs) -> KWArgs:
        self.param, remain = BCDLearnerParam.init_allow_unknown(kwargs)
        self.uparam, remain = BCDUpdaterParam.init_allow_unknown(remain)
        if self.uparam.V_dim != 0:
            raise ValueError("bcd supports V_dim=0 only (linear model), like "
                             "the reference (bcd_updater.h InitWeights)")
        self.dev = resolve_device(self.device)
        self.mesh = None
        if self.param.mesh_dp > 1:
            from ..parallel import make_mesh
            from ..parallel.mesh import process_count
            if process_count() > 1:
                raise ValueError(
                    "bcd multi-host runs shard rows across hosts; in-host "
                    "row sharding (mesh_dp > 1) is single-host only — set "
                    "mesh_dp=1 under launch.py")
            self.mesh = make_mesh(dp=self.param.mesh_dp, fs=1,
                                  device=self.device)
            self.dev = self.mesh.home
        return remain

    # ----------------------------------------------------------- data prep
    def _prepare(self) -> None:
        """PrepareData + BuildFeatureMap (bcd_learner.cc:96-155): read and
        localize every tile, filter the tail, partition the blocks."""
        p, up = self.param, self.uparam
        tb = TileBuilder()
        stats = np.zeros((1 << p.num_feature_group_bits) + 2,
                         dtype=np.float64)
        for blk in Reader(p.data_in, p.data_format,
                          chunk_bytes=p.data_chunk_size):
            add_group_stats(stats, blk, p.num_feature_group_bits)
            tb.add(blk, is_train=True)
        if p.data_val:
            for blk in Reader(p.data_val, p.data_format,
                              chunk_bytes=p.data_chunk_size):
                tb.add(blk, is_train=False)
        self.ntrain, self.nval = tb.nrows_train, tb.nrows_val
        self.feaids = tb.filter_tail(up.tail_feature_filter)
        nf = len(self.feaids)

        # partition feature blocks (RunScheduler, bcd_learner.cc:60-72)
        ngrp = 1 << p.num_feature_group_bits
        feagrp = []
        for g in range(ngrp):
            nblk = int(np.ceil(stats[g] / max(stats[ngrp], 1)
                               * p.block_ratio))
            if nblk > 0:
                feagrp.append((g, nblk))
        ranges = partition_feature(p.num_feature_group_bits, feagrp)
        # block f owns the filtered features in [begin, end)
        begins = np.searchsorted(self.feaids, np.array(
            [r[0] for r in ranges], dtype=FEAID_DTYPE))
        ends = np.searchsorted(self.feaids, np.array(
            [r[1] for r in ranges], dtype=FEAID_DTYPE))
        self.blocks = [(int(b), int(e)) for b, e in zip(begins, ends)
                       if e > b]
        log.info("loaded %d examples; %d features in %d blocks",
                 self.ntrain, nf, len(self.blocks))

        # model state (host: O(nf) elementwise)
        self.w = np.zeros(nf, dtype=np.float32)
        self.delta = np.ones(nf, dtype=np.float32)  # bcd::Delta init 1.0

        # row tiles: labels/mask/pred on the device, the COO on the host;
        # under a mesh the row caps divide by dp
        from ..ops.batch import mesh_dim_min
        dim_min = 8 if self.mesh is None else mesh_dim_min(p.mesh_dp)
        self.tiles = []
        for t, (cblk, _, is_train) in enumerate(tb.tiles):
            b_cap = bucket(cblk.size, dim_min)
            rowf = np.zeros((3, b_cap), dtype=np.float32)
            rowf[0, :cblk.size] = cblk.label
            rowf[1, :cblk.size] = 1.0
            dev = torch.from_numpy(rowf).to(self.dev)
            self.tiles.append(dict(
                size=cblk.size, b_cap=b_cap, is_train=is_train,
                rows=cblk.row_ids(),
                col_global=tb.colmap(t)[cblk.index],  # -1 where filtered
                vals=cblk.values_or_ones(), label_np=cblk.label,
                labels=dev[0], mask=dev[1], pred=dev[2]))
        self._tile_cache = TileCache(self._build_slice,
                                     max_items=p.tile_cache_items,
                                     max_bytes=p.tile_cache_mb << 20)

    def _build_slice(self, t: int, f: int):
        """Tile t's entries in block f as a device COO (block-local
        columns), padded to ``bucket(nnz)`` with (0, 0, 0.0); None when
        the tile has none. Under a mesh, ``(slice, shards)``: the same
        slice and its dp row shards, each with shard-local rows, padded to
        the bucket of the largest and placed on its block's device (the
        JAX learner's per-dp COO)."""
        tile = self.tiles[t]
        b_lo, b_hi = self.blocks[f]
        m = (tile["col_global"] >= b_lo) & (tile["col_global"] < b_hi)
        nnz = int(m.sum())
        if nnz == 0:
            return None
        rows_g = tile["rows"][m]
        cols_g = tile["col_global"][m] - b_lo
        vals_g = tile["vals"][m]
        full = self._coo(rows_g, cols_g, vals_g, bucket(nnz), self.dev)
        if self.mesh is None:
            return full
        dp = self.mesh.dp
        shard = tile["b_cap"] // dp
        part = rows_g // shard
        cap = bucket(max(int(np.bincount(part, minlength=dp).max()), 1))
        shards = tuple(
            self._coo(rows_g[part == d] - d * shard, cols_g[part == d],
                      vals_g[part == d], cap, self.dev)
            for d in range(dp))
        return full, shards

    @staticmethod
    def _coo(rows, cols, vals, cap: int, dev) -> BlockSlice:
        n = len(rows)
        idx = np.zeros((2, cap), dtype=np.int32)
        idx[0, :n] = rows
        idx[1, :n] = cols
        v = np.zeros(cap, dtype=np.float32)
        v[:n] = vals
        idx = torch.from_numpy(idx).to(dev)
        return BlockSlice(rows=idx[0], cols=idx[1],
                          vals=torch.from_numpy(v).to(dev))

    def _slice_grad(self, tile: dict, s, nf_cap: int) -> torch.Tensor:
        """(g, h) of one (tile, block) slice: the whole slice, or under a
        mesh each dp row shard's partial on its device, summed in dp
        order."""
        if self.mesh is None:
            return delta_grad(tile["pred"], tile["labels"], tile["mask"], s,
                              nf_cap)
        shards = s[1]
        m = tile["b_cap"] // len(shards)
        gh = None
        for d, part in enumerate(shards):
            dev = part.rows.device
            lo, hi = d * m, (d + 1) * m
            g = delta_grad(tile["pred"][lo:hi].to(dev),
                           tile["labels"][lo:hi].to(dev),
                           tile["mask"][lo:hi].to(dev), part,
                           nf_cap).to(self.dev)
            gh = g if gh is None else gh + g
        return gh

    # ----------------------------------------------------------- epoch
    def _iterate_block(self, f: int) -> None:
        """IterateFeablk (bcd_learner.cc:196-233): grad -> update -> pred."""
        up = self.uparam
        b_lo, b_hi = self.blocks[f]
        nf_blk = b_hi - b_lo
        nf_cap = bucket(nf_blk)

        gh = torch.zeros((nf_cap, 2), dtype=torch.float32, device=self.dev)
        for t, tile in enumerate(self.tiles):
            if not tile["is_train"]:
                continue
            s = self._tile_cache.fetch(t, f)
            if s is not None:
                gh = gh + self._slice_grad(tile, s, nf_cap)
        # (g, h) leave the device in one copy
        gh = gh.cpu().numpy()
        g_np = gh[:nf_blk, 0].astype(np.float64)
        h_np = gh[:nf_blk, 1].astype(np.float64)

        # diag-Newton + trust region (UpdateWeight, bcd_updater.h:139-159)
        w = self.w[b_lo:b_hi].astype(np.float64)
        dlt = self.delta[b_lo:b_hi]
        g_pos, g_neg = g_np + up.l1, g_np - up.l1
        u = h_np / up.lr + 1e-10
        d = np.where(g_pos <= u * w, -g_pos / u,
                     np.where(g_neg >= u * w, -g_neg / u, -w))
        d = np.clip(d, -dlt, dlt).astype(np.float32)
        self.delta[b_lo:b_hi] = np.minimum(5.0, np.abs(d) * 2 + 0.1)
        self.w[b_lo:b_hi] += d

        d_cap = np.zeros(nf_cap, dtype=np.float32)
        d_cap[:nf_blk] = d
        d_dev = torch.from_numpy(d_cap).to(self.dev)
        for t, tile in enumerate(self.tiles):  # train AND val (UpdtPred)
            s = self._tile_cache.fetch(t, f)
            if s is not None:
                full = s if self.mesh is None else s[0]
                tile["pred"] = delta_pred_update(tile["pred"], full, d_dev)

    def _progress(self) -> BCDProgress:
        preds = torch.cat([t["pred"][:t["size"]]
                           for t in self.tiles]).cpu().numpy()
        count = objv = auc = acc = 0.0
        o = 0
        for tile in self.tiles:
            pred = preds[o:o + tile["size"]]
            o += tile["size"]
            lab = tile["label_np"]
            count += tile["size"]
            objv += logit_objv_np(lab, pred)
            auc += auc_times_n_np(lab, pred)
            acc += accuracy_times_n(lab, pred, 0.5)
        return BCDProgress(count=count, objv=objv, auc=auc, acc=acc,
                           nnz_w=float(np.sum(self.w != 0)))

    # ----------------------------------------------------------- run
    def run(self) -> None:
        """RunScheduler (bcd_learner.cc:51-93)."""
        p = self.param
        self._prepare()
        if p.model_in:
            self.load(p.model_in)
        order = np.arange(len(self.blocks))
        rng = np.random.RandomState(p.seed)
        step_h = REGISTRY.histogram(
            "train_step_seconds",
            "host-side dispatch+wait time of one fused device step"
        ).labels(learner="bcd")
        for epoch in range(p.max_num_epochs):
            if p.random_block:
                rng.shuffle(order)
            with trace.span("epoch", epoch=epoch, learner="bcd"):
                for f in order:
                    t0 = time.perf_counter()
                    with trace.span("bcd.block", block=int(f)):
                        self._iterate_block(int(f))
                    step_h.observe(time.perf_counter() - t0)
            prog = self._progress()
            n = max(prog.count, 1)
            log.info("epoch: %d, objv: %.9g, auc: %.9g, acc: %.9g, "
                     "nnz(w): %d, rows: %d", epoch, prog.objv / n,
                     prog.auc / n, prog.acc / n, int(prog.nnz_w),
                     int(prog.count))
            for cb in self.epoch_end_callbacks:
                cb(epoch, prog)
        if p.model_out:
            self.save(p.model_out)

    # ----------------------------------------------------------- ckpt
    @staticmethod
    def _ckpt_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        """The JAX package's keys (feaids, w, learner) and manifest."""
        p = self._ckpt_path(path)
        stream.save_npz(p, feaids=self.feaids, w=self.w,
                        learner=np.array("bcd"),
                        manifest={"learner": "bcd",
                                  "rows": int(len(self.feaids)),
                                  "generation": mft.next_generation(p)},
                        fault_point="ckpt.write")

    def load(self, path: str) -> None:
        """Take the saved w of the features both hold; then rebuild every
        tile's pred = X w on the host, as the JAX package does."""
        with stream.load_npz(self._ckpt_path(path)) as z:
            pos = find_position(z["feaids"].astype(FEAID_DTYPE), self.feaids)
            ok = pos >= 0
            self.w[ok] = z["w"][pos[ok]]
        for tile in self.tiles:
            pred = np.zeros(tile["b_cap"], dtype=np.float32)
            valid = tile["col_global"] >= 0
            np.add.at(pred, tile["rows"][valid],
                      tile["vals"][valid] * self.w[tile["col_global"][valid]])
            tile["pred"] = torch.from_numpy(pred).to(self.dev)
