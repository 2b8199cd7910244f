"""Vector-free L-BFGS learner, linear and FM (counterpart of
difacto_tpu/learners/lbfgs.py; the reference's src/lbfgs/).

- The model is ONE flat device vector ``weights[N_pad]`` in the
  reference's variable-length layout ``[w_i, V_i...]`` per kept feature
  (lbfgs_updater.h:45-56), then a trash/pad region of zeros; the
  two-loop's inner products are plain dots over it.
- The training data is cached as device tiles (:class:`Tile`: the COO
  batch of ops/batch.pad_batch and each uniq feature's positions
  ``w_pos``/``v_pos`` in the flat vector, the analog of TileStore colmaps
  + GetPos, lbfgs_learner.cc:293-313), in a byte-bounded
  data/tile_store.TileCache (``tile_cache_mb``) or all resident
  (``tile_cache_mb=0``).
- f and ∇f (``_calc_grad``): per tile the FM forward and backward of
  losses/fm.py, objective and exact AUC, and the loss gradient added
  into a flat gradient; one copy of the tile's (objv, auc) to the host,
  summed there in float64.
- The Gram matrix B of [s, y, g] is one matmul on the card, cast to
  float64 on the host, where the two-loop coefficients are solved
  (learners/twoloop.py); the direction is one matvec, clipped to ±5.
  These stay ``torch.matmul``/``torch.dot`` in float32: TF32 must be off
  (``torch.backends.cuda.matmul.allow_tf32`` False and
  ``torch.get_float32_matmul_precision() == "highest"``, torch's
  defaults).
- The Wolfe line search fetches its three scalars in one copy.

**The gradient's scatter.** A tile's kept features have unique positions
in the flat vector; every filtered feature (and every pad lane) points at
the shared trash slot ``trash_w = N_pad - 1`` and the trash block
``[trash_v, trash_v + k)``, and so does the V block of a kept feature
without an embedding. The gradient is added with a plain indexed write,
``grad[pos] = grad[pos] + g`` (``index_put_`` without ``accumulate``):
each kept position is written once, with the same single add as JAX's
scatter-add, and no atomics are involved; the trash slots take one of
their racing writes, and ``_finish_grad`` zeroes everything past ``N``.
So a tile's result does not depend on any write order.

The scheduler (RunScheduler, lbfgs_learner.cc:14-108) is the JAX
package's step for step, with its stop criteria and the epoch-0 alpha
heuristic ntrain/nnz.

``mesh_fs > 1`` shards the flat vector over a ``(1, fs)`` mesh
(parallel/mesh.py), as the JAX learner does: ``N_pad`` divides by fs
(``mesh_dim_min``), the vector's fs contiguous ranges are its shards,
and every reduction over it (the Gram matrix, the dots of the line
search, the regularizer) is a per-shard partial on the shard's device,
summed in fs order; elementwise updates and the tiles' gathers see the
same values either way. The multi-host branches (the gradient
allreduce, ``global_kv_union``) are ROADMAP.md item 11b.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..base import FEAID_DTYPE
from ..config import KWArgs, Param
from ..data.reader import Reader
from ..data.tile_builder import TileBuilder
from ..data.tile_store import TileCache
from ..losses.fm import FMParams, fm_grad, fm_predict, logit_objv
from ..losses.metrics import auc_times_n
from ..obs import REGISTRY, trace
from ..ops.batch import DeviceBatch, bucket, pad_batch
from ..ops.kv import expand_ranges, find_position
from ..utils import manifest as mft
from ..utils import stream
from ..utils.platform import resolve_device
from .base import Learner, register
from .twoloop import calc_delta

log = logging.getLogger("difacto_tpu_torch")


@dataclass
class LBFGSLearnerParam(Param):
    """src/lbfgs/lbfgs_param.h:10-77, with the JAX package's defaults."""
    data_in: str = ""
    data_val: str = ""
    data_format: str = "libsvm"
    data_cache: str = ""
    model_out: str = ""
    model_in: str = ""
    loss: str = "fm"
    max_num_epochs: int = 100
    min_num_epochs: int = 10
    data_chunk_size: float = 256  # MB
    stop_rel_objv: float = 1e-5
    stop_val_auc: float = 1e-5
    load_epoch: int = 0
    init_alpha: float = 0.0  # 0 = ntrain/nnz heuristic (lbfgs_learner.cc:49)
    alpha: float = 1.0
    c1: float = 1e-4
    c2: float = 0.9
    rho: float = 0.5
    gamma: float = 1.0
    max_num_linesearchs: int = 5
    num_threads: int = 0  # accepted for config parity
    mesh_fs: int = 1
    tile_cache_mb: int = 1024


@dataclass
class LBFGSUpdaterParam(Param):
    """src/lbfgs/lbfgs_param.h:79-104. V_dim is required."""
    V_dim: int = -1
    V_threshold: int = 0
    V_init_scale: float = 0.01
    tail_feature_filter: int = 4
    l2: float = 0.1
    V_l2: float = 0.01
    m: int = 10
    seed: int = 0


class LBFGSProgress(NamedTuple):
    """lbfgs::Progress (src/lbfgs/lbfgs_utils.h:45-63)."""
    objv: float = 0.0
    auc: float = 0.0
    val_auc: float = 0.0
    nnz_w: float = 0.0


class Tile(NamedTuple):
    """A cached device chunk: COO batch + positions into the flat vector."""
    batch: DeviceBatch
    w_pos: torch.Tensor   # i32[U_cap] position of w (trash slot if filtered)
    v_pos: torch.Tensor   # i32[U_cap] position of V's start (trash if none)
    v_mask: torch.Tensor  # f32[U_cap] 1 where the feature has an embedding


@register("lbfgs")
class LBFGSLearner(Learner):
    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = device
        self.param: Optional[LBFGSLearnerParam] = None
        self.weight_initializer: Optional[Callable] = None
        self.epoch_end_callbacks: List[Callable[[int, LBFGSProgress], None]] \
            = []

    # ----------------------------------------------------------- init
    def init(self, kwargs: KWArgs) -> KWArgs:
        self.param, remain = LBFGSLearnerParam.init_allow_unknown(kwargs)
        self.uparam, remain = LBFGSUpdaterParam.init_allow_unknown(remain)
        if self.uparam.V_dim < 0:
            raise ValueError("V_dim is required for the lbfgs learner")
        if self.param.loss == "logit":
            self.uparam = dataclasses.replace(self.uparam, V_dim=0)
        self.k = self.uparam.V_dim
        self.dev = resolve_device(self.device)
        self.mesh = None
        if self.param.mesh_fs > 1:
            from ..parallel import make_mesh
            from ..parallel.mesh import process_count
            if process_count() > 1:
                raise ValueError(
                    "lbfgs multi-host runs shard DATA across hosts; in-host "
                    "vector sharding (mesh_fs > 1) is single-host only — "
                    "set mesh_fs=1 under launch.py")
            self.mesh = make_mesh(dp=1, fs=self.param.mesh_fs,
                                  device=self.device)
            self.dev = self.mesh.home
        return remain

    # ------------------------------------------------- the sharded vector
    def _shards(self, x: torch.Tensor) -> list:
        """The flat vector's fs key-range shards (views)."""
        fs = self.mesh.fs
        n = x.shape[-1] // fs
        return [x[..., f * n:(f + 1) * n] for f in range(fs)]

    def _vsum(self, parts) -> torch.Tensor:
        """Per-shard partials summed in fs order."""
        out = None
        for q in parts:
            out = q if out is None else out + q
        return out

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return torch.dot(a, b)
        return self._vsum(torch.dot(x, y) for x, y in
                          zip(self._shards(a), self._shards(b)))

    def _gram(self, basis: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return basis @ basis.T
        return self._vsum(x @ x.T for x in self._shards(basis))

    def _put_vec(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.dev)

    def set_weight_initializer(self, fn: Callable) -> None:
        """fn(lens: int32[n_feat], weights: f32[N]) -> f32[N], the
        deterministic-init hook (SetWeightInitializer,
        lbfgs_updater.h:27-32) the golden tests use."""
        self.weight_initializer = fn

    # ----------------------------------------------------------- data prep
    def _prepare_data(self) -> None:
        """PrepareData (lbfgs_learner.cc:146-194): read once through the
        TileBuilder, keeping the compact blocks and the global (id, count)
        dictionary."""
        p = self.param
        chunk = int(p.data_chunk_size * (1 << 20))
        tb = TileBuilder()
        for blk in Reader(p.data_in, p.data_format, chunk_bytes=chunk):
            tb.add(blk, is_train=True)
        if p.data_val:
            for blk in Reader(p.data_val, p.data_format, chunk_bytes=chunk):
                tb.add(blk, is_train=False)
        self._builder = tb
        self._raw = {"train": [(cb, u) for cb, u, t in tb.tiles if t],
                     "val": [(cb, u) for cb, u, t in tb.tiles if not t]}
        self.ntrain, self.nval = tb.nrows_train, tb.nrows_val
        self.train_nnz = tb.nnz_train
        log.info("found %d training examples, %d features",
                 self.ntrain, len(tb.ids))

    def _init_model(self) -> None:
        """InitServer + InitWorker (lbfgs_updater.h:35-77,
        lbfgs_learner.cc:196-219): tail filter, [w, V...] layout, V init,
        the regularizer vector and the tiles."""
        up = self.uparam
        self.feaids = self._builder.filter_tail(up.tail_feature_filter)
        self.feacnts = self._builder.cnts
        nf = len(self.feaids)
        if up.V_dim > 0:
            lens = 1 + np.where(self.feacnts > up.V_threshold, up.V_dim, 0)
        else:
            lens = np.ones(nf, dtype=np.int64)
        self.lens = lens.astype(np.int32)
        self._set_layout()

        w = np.zeros(self.N_pad, dtype=np.float32)
        if self.weight_initializer is not None:
            w[:self.N] = self.weight_initializer(self.lens,
                                                 w[:self.N].copy())
        elif up.V_dim > 0:
            # uniform V init (InitWeight, lbfgs_updater.h:60-70), the JAX
            # package's RandomState draw over the flat layout
            rng = np.random.RandomState(up.seed)
            vals = (rng.rand(self.N) - 0.5) * (2 * up.V_init_scale)
            is_w = np.zeros(self.N, dtype=bool)
            is_w[self.offsets[:-1]] = True
            w[:self.N] = np.where(is_w, 0.0, vals)
        self.weights = self._put_vec(w)

        self._n_tiles = {k: len(v) for k, v in self._raw.items()}
        if self.param.tile_cache_mb > 0:
            # device tiles in a byte-budgeted LRU, rebuilt from the kept
            # host blocks on a miss
            self._tile_cache = TileCache(
                lambda which, i: self._build_tile(*self._raw[which][i]),
                max_bytes=self.param.tile_cache_mb << 20)
        else:
            self._tile_cache = None
            self._res_tiles = {k: [self._build_tile(cb, u) for cb, u in v]
                               for k, v in self._raw.items()}
            del self._raw

    def _set_layout(self) -> None:
        """Offsets, N, N_pad and the trash slots of ``self.lens``, and the
        device constants tied to them: the per-coordinate regularizer (l2
        on w positions, V_l2 on V) and the mask of real coordinates."""
        nf = len(self.lens)
        self.offsets = np.zeros(nf + 1, dtype=np.int64)
        np.cumsum(self.lens, out=self.offsets[1:])
        self.N = int(self.offsets[-1])
        # trailing trash/pad region; the last V_dim+1 slots are reserved so
        # the trash V rows stay in bounds; under a mesh N_pad divides by fs
        from ..ops.batch import mesh_dim_min
        dim_min = 8 if self.mesh is None else mesh_dim_min(self.mesh.fs)
        self.N_pad = bucket(self.N + self.k + 1, dim_min)
        self.trash_w = self.N_pad - 1
        self.trash_v = self.N_pad - 1 - self.k
        c = np.zeros(self.N_pad, dtype=np.float32)
        c[:self.N] = self.uparam.V_l2
        c[self.offsets[:-1]] = self.uparam.l2
        self.reg_c = self._put_vec(c)
        self._real = torch.arange(self.N_pad, device=self.dev) < self.N

    def _iter_tiles(self, which: str):
        if self._tile_cache is None:
            yield from self._res_tiles[which]
            return
        for i in range(self._n_tiles[which]):
            yield self._tile_cache.fetch(which, i)

    def _warm_start(self, path: str) -> int:
        """Copy checkpoint weights into the current layout (``model_in``):
        the features present in both with the same row length take the
        saved values; the rest keep their init. Returns the match count."""
        with stream.load_npz(self._ckpt_path(path)) as z:
            if int(z["V_dim"]) != self.k:
                raise ValueError("checkpoint V_dim mismatch")
            ck_ids, ck_lens, ck_w = z["feaids"], z["lens"], z["weights"]
        ck_off = np.zeros(len(ck_ids) + 1, dtype=np.int64)
        np.cumsum(ck_lens, out=ck_off[1:])
        pos = find_position(ck_ids.astype(FEAID_DTYPE), self.feaids)
        ok = (pos >= 0) & (ck_lens[np.maximum(pos, 0)] == self.lens)
        if not ok.any():
            return 0
        lens = self.lens[ok].astype(np.int64)
        src_idx = expand_ranges(ck_off[pos[ok].astype(np.int64)], lens)
        dst_idx = expand_ranges(self.offsets[:-1][ok], lens)
        w = self.weights.cpu().numpy().copy()
        w[dst_idx] = ck_w[src_idx]
        self.weights = self._put_vec(w)
        return int(ok.sum())

    def _build_tile(self, cblk, uniq: np.ndarray) -> Tile:
        """BuildColmap + GetPos (tile_builder.h:115-183,
        lbfgs_learner.cc:293-313): the tile's features' flat positions."""
        colmap = find_position(self.feaids, uniq)
        hit = colmap >= 0
        u_cap = bucket(len(uniq))
        pos = np.zeros((2, u_cap), dtype=np.int32)   # w_pos, v_pos
        pos[0] = self.trash_w
        pos[1] = self.trash_v
        pos[0, :len(uniq)][hit] = self.offsets[colmap[hit]]
        has_v = hit & (self.lens[np.maximum(colmap, 0)] > 1)
        pos[1, :len(uniq)][has_v] = pos[0, :len(uniq)][has_v] + 1
        v_mask = np.zeros(u_cap, dtype=np.float32)
        v_mask[:len(uniq)] = has_v
        batch = pad_batch(cblk, num_uniq=len(uniq),
                          batch_cap=bucket(cblk.size),
                          nnz_cap=bucket(cblk.nnz), device=self.dev)
        pos = self._put_vec(pos)
        return Tile(batch=batch, w_pos=pos[0], v_pos=pos[1],
                    v_mask=self._put_vec(v_mask))

    # ----------------------------------------------------------- steps
    def _v_index(self, tile: Tile) -> torch.Tensor:
        return (tile.v_pos.long()[:, None]
                + torch.arange(self.k, device=self.dev)[None, :])

    def _gather_params(self, weights: torch.Tensor, tile: Tile) -> FMParams:
        w = weights[tile.w_pos.long()]
        if self.k == 0:
            return FMParams(w=w)
        V = weights[self._v_index(tile)] * tile.v_mask[:, None]
        return FMParams(w=w, V=V, v_mask=tile.v_mask)

    def _tile_grad(self, weights, grad, tile: Tile):
        """(objv, auc) on this tile; the loss gradient added into
        ``grad`` in place (the module docstring's scatter)."""
        params = self._gather_params(weights, tile)
        b = tile.batch
        pred = fm_predict(params, b)
        objv = logit_objv(pred, b)
        auc = auc_times_n(b.labels, pred, b.row_mask)
        gw, gV = fm_grad(params, b, pred)
        w_pos = tile.w_pos.long()
        grad.index_put_((w_pos,), grad[w_pos] + gw)
        if gV is not None:
            vi = self._v_index(tile).reshape(-1)
            grad.index_put_((vi,), grad[vi] + (gV * tile.v_mask[:, None])
                            .reshape(-1))
        return torch.stack([objv, auc])

    def _tile_pred_auc(self, weights, tile: Tile) -> torch.Tensor:
        pred = fm_predict(self._gather_params(weights, tile), tile.batch)
        return auc_times_n(tile.batch.labels, pred, tile.batch.row_mask)

    def _finish_grad(self, grad: torch.Tensor) -> torch.Tensor:
        """The gamma transform (CalcGrad, lbfgs_learner.cc:283-286), and
        zeros past ``N`` so dots and axpys see none of the trash region."""
        gamma = self.param.gamma
        if gamma != 1:
            grad = torch.sign(grad) * torch.abs(grad) ** gamma
        return torch.where(self._real, grad, torch.zeros_like(grad))

    def _reg_objv(self, weights) -> torch.Tensor:
        r = self.reg_c * weights * weights
        if self.mesh is None:
            return 0.5 * torch.sum(r)
        return 0.5 * self._vsum(torch.sum(x) for x in self._shards(r))

    def _calc_grad(self, weights):
        """f(w), train AUC x n and the loss gradient: one pass over the
        train tiles, one host copy of (objv, auc) per tile."""
        grad = torch.zeros(self.N_pad, dtype=torch.float32, device=self.dev)
        objv = auc = 0.0
        step_h = REGISTRY.histogram(
            "train_step_seconds",
            "host-side dispatch+wait time of one fused device step"
        ).labels(learner="lbfgs")
        for tile in self._iter_tiles("train"):
            t0 = time.perf_counter()
            with trace.span("lbfgs.tile_grad"):
                oa = self._tile_grad(weights, grad, tile).cpu().numpy()
                objv += float(oa[0])
                auc += float(oa[1])
            step_h.observe(time.perf_counter() - t0)
        return objv, auc, self._finish_grad(grad)

    # ----------------------------------------------------------- run
    def run(self) -> None:
        """RunScheduler (lbfgs_learner.cc:14-108)."""
        p, up = self.param, self.uparam
        self._prepare_data()
        self._init_model()
        log.info("inited model with %d parameters", self.N)
        if p.model_in:
            n = self._warm_start(p.model_in)
            log.info("warm start from %s: %d features matched", p.model_in, n)
        r0 = float(self._reg_objv(self.weights))
        f0, auc, g_loss = self._calc_grad(self.weights)
        objv = r0 + f0

        s_hist: List[torch.Tensor] = []
        y_hist: List[torch.Tensor] = []
        grads = None          # g at the accepted w, with the regularizer
        alpha = 0.0
        val_auc_prev = 0.0
        new_objv = objv

        for epoch in range(max(p.load_epoch, 0), p.max_num_epochs):
            log.info("epoch %d:", epoch)
            # kPushGradient + kPrepareCalcDirection (lbfgs_updater.h:84-99)
            new_grads = g_loss + self.reg_c * self.weights
            if grads is not None:
                if len(y_hist) == up.m:
                    y_hist.pop(0)
                y_hist.append(new_grads - grads)
                # s_last was stored unscaled; scale it by the accepted
                # alpha (PrepareCalcDirection, lbfgs_updater.h:95-97)
                s_hist[-1] = alpha * s_hist[-1]
            grads = new_grads
            alpha = 0.0

            # kCalcDirection (lbfgs_updater.h:105-121): two-loop or -g
            if y_hist:
                basis = torch.stack([*s_hist, *y_hist, grads])
                B = self._gram(basis).cpu().numpy().astype(np.float64)
                delta = torch.from_numpy(calc_delta(B).astype(np.float32))
                direction = delta.to(self.dev) @ basis
            else:
                direction = -grads
            direction = torch.clamp(direction, -5.0, 5.0)
            if len(s_hist) == up.m:
                s_hist.pop(0)
            s_hist.append(direction)
            p_gf = float(self._dot(grads, direction))

            # line search (lbfgs_learner.cc:46-71)
            log.info(" - start linesearch with objv = %g, <p,g> = %g",
                     objv, p_gf)
            if epoch != 0:
                trial = p.alpha
            else:
                trial = p.init_alpha if p.init_alpha > 0 \
                    else self.ntrain / self.train_nnz
            for i in range(p.max_num_linesearchs):
                self.weights = self.weights + (trial - alpha) * direction
                alpha = trial
                f_new, auc, g_loss = self._calc_grad(self.weights)
                # the Wolfe test's three scalars in one host copy
                ls = torch.stack([
                    self._reg_objv(self.weights),
                    self._dot(g_loss, direction),
                    self._dot(self.reg_c * self.weights, direction),
                ]).cpu().numpy()
                new_objv = f_new + float(ls[0])
                pg_new = float(ls[1]) + float(ls[2])
                log.info(" - alpha = %g, objv = %g, <p,g> = %g",
                         trial, new_objv, pg_new)
                if (new_objv <= objv + p.c1 * trial * p_gf
                        and pg_new >= p.c2 * p_gf):
                    log.info(" - wolfe condition is satisfied")
                    break
                if i + 1 == p.max_num_linesearchs:
                    log.info(" - reached max linesearch steps [%d]", i + 1)
                trial *= p.rho

            # kEvaluate (lbfgs_learner.cc:72-84)
            val_auc = 0.0
            for tile in self._iter_tiles("val"):
                val_auc += float(self._tile_pred_auc(self.weights, tile))
            prog = LBFGSProgress(
                objv=new_objv,
                auc=auc / max(self.ntrain, 1),
                val_auc=val_auc / self.nval if self.nval else 0.0,
                nnz_w=float(torch.count_nonzero(self.weights)))
            log.info("epoch %d: objv = %.9g, training AUC = %.9g, "
                     "validation AUC = %.9g, nnz(w) = %d", epoch,
                     prog.objv, prog.auc, prog.val_auc, int(prog.nnz_w))
            for cb in self.epoch_end_callbacks:
                cb(epoch, prog)

            # stop criteria (lbfgs_learner.cc:86-103)
            if epoch > p.min_num_epochs:
                eps = abs(new_objv - objv) / objv
                if eps < p.stop_rel_objv:
                    log.info("change of objv [%g] < stop_rel_objv", eps)
                    break
                if self.nval:
                    eps = prog.val_auc - val_auc_prev
                    if eps < p.stop_val_auc:
                        log.info("change of val auc [%g] < stop_val_auc", eps)
                        break
            objv = new_objv
            val_auc_prev = prog.val_auc

        if p.model_out:
            self.save(p.model_out)
        log.info("training is done")

    # ----------------------------------------------------------- ckpt
    @staticmethod
    def _ckpt_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        """The JAX package's keys (feaids, lens, weights, V_dim, learner)
        and manifest."""
        p = self._ckpt_path(path)
        stream.save_npz(p, feaids=self.feaids, lens=self.lens,
                        weights=self.weights[:self.N].cpu().numpy(),
                        V_dim=np.array(self.k), learner=np.array("lbfgs"),
                        manifest={"learner": "lbfgs",
                                  "rows": int(len(self.feaids)),
                                  "generation": mft.next_generation(p)},
                        fault_point="ckpt.write")

    def load(self, path: str) -> None:
        """Replace the model with a checkpoint's layout and weights."""
        with stream.load_npz(self._ckpt_path(path)) as z:
            if int(z["V_dim"]) != self.k:
                raise ValueError("checkpoint V_dim mismatch")
            self.feaids = z["feaids"]
            self.lens = z["lens"]
            w = z["weights"]
        self._set_layout()
        buf = np.zeros(self.N_pad, dtype=np.float32)
        buf[:self.N] = w
        self.weights = self._put_vec(buf)
