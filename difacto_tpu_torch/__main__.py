"""CLI entry: ``python -m difacto_tpu_torch [config_file] key=val ...``
(counterpart of difacto_tpu/__main__.py), with the JAX CLI's key names.

- ``task=pred`` — score ``data_val`` (or ``data_in``) with the model
  ``model_in`` through the serving predict executor, in ``batch_size``
  windows, writing ``<pred_out>_part-0`` in the JAX package's format
  (``label\\tprob`` per row, ``%g``).
- ``task=serve`` — the online scoring server over ``model_in``
  (serve/__init__.py run_serve).
- ``task=train`` (the default) — the learner named by ``learner``
  (``Learner.create``): ``sgd`` (learners/sgd.py: FM or logistic
  regression on the flat ``V_dim=0`` table, on the hashed or the
  dictionary store, with the replay cache, saving ``<model_out>_part-0``
  with the optimizer state when ``has_aux=1``), ``bcd`` (learners/bcd.py,
  ℓ1 block coordinate descent) or ``lbfgs`` (learners/lbfgs.py,
  vector-free L-BFGS, linear or FM), the batch learners saving
  ``<model_out>.npz``. ``examples/local.conf``, ``examples/fm.conf``,
  ``examples/bcd.conf`` and ``examples/lbfgs.conf`` run as they are. The
  Criteo configs set a ``mesh_dp = 2``, ``mesh_fs = 4`` mesh
  (parallel/mesh.py): on one card they need
  ``DIFACTO_TORCH_VIRTUAL_DEVICES=8`` (eight logical devices on it), or
  ``mesh_dp=1 mesh_fs=1`` to train flat; without either they raise "need
  8 devices, have 1", as the JAX package does on too few devices.

- ``task=dump`` — a saved model as readable TSV (``name_dump``; the
  reference's src/reader/dump.h, the JAX package's bytes).
- ``task=convert`` — text or rec input to libsvm text or the binary rec
  cache (data/converter.py), which ``data_format=rec`` trains from.
- ``task=online`` — the tailing trainer over a serving replica's training
  log (online/__init__.py run_online).

``device=cuda`` (the default) runs on the card and raises when there is
none; ``device=cpu`` runs on the CPU (convert runs on the host alone).
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .config import KWArgs, Param, parse_cli_args, warn_unknown

log = logging.getLogger("difacto_tpu_torch")


@dataclass
class DifactoParam(Param):
    task: str = field(default="train", metadata=dict(
        enum=["train", "dump", "pred", "convert", "serve", "online"]))
    learner: str = "sgd"
    device: str = "cuda"


def _pred_routing_error(learner: str, kwargs: KWArgs) -> ValueError:
    """task=pred with a non-sgd learner: the JAX package's message, which
    names the learner that produced ``model_in`` (from the checkpoint's
    own marker) and points at the tasks that exist."""
    model_in = next((v for k, v in reversed(kwargs) if k == "model_in"), "")
    produced = ""
    if model_in:
        try:
            from .serve.model import model_meta
            meta = model_meta(model_in)
            if meta["learner"]:
                produced = (f"; model_in={model_in!r} was produced by "
                            f"learner={meta['learner']!r}")
        except Exception as e:  # an unreadable model keeps the base text
            log.debug("model meta unreadable for %s: %s", model_in, e)
    return ValueError(
        f"task=pred runs the bucketed sgd predict executor and is not "
        f"implemented by learner={learner!r}{produced}. Batch-score sgd "
        f"models with learner=sgd, or use task=serve for online scoring "
        f"(docs/serving.md)")


@dataclass
class PredMeshParam(Param):
    """The training mesh keys as task=pred reads them: under
    ``mesh_dp * mesh_fs > 1`` or ``mesh_force`` the JAX learner scores on
    its mesh (its epoch path); the port opens the serving store on that
    mesh and scores through the same executor, one gather launch per
    shard run, so the scores equal the flat ones byte for byte."""
    mesh_dp: int = 1
    mesh_fs: int = 1
    mesh_force: bool = False


@dataclass
class PredParam(Param):
    """The pred keys of the JAX sgd learner (SGDLearnerParam)."""
    data_in: str = ""
    data_val: str = ""
    data_format: str = "libsvm"
    model_in: str = ""
    loss: str = "fm"
    batch_size: int = field(default=100, metadata=dict(lo=1))
    pred_out: str = ""
    pred_prob: bool = True


class PredWriter:
    """SavePred (sgd_learner.h:72-83): one bulk-formatted write per
    batch, ``%g\\t%g`` label and score per row — the JAX package's
    ``_save_pred`` byte for byte."""

    def __init__(self, path: str, pred_prob: bool):
        from .utils import stream
        self._f = stream.open_stream(path, "w")
        self.pred_prob = pred_prob

    def write(self, pred: np.ndarray, label) -> None:
        from .serve.executor import sigmoid
        out = sigmoid(pred) if self.pred_prob else pred
        n = len(out)
        if n == 0:
            return
        if label is not None:
            inter = np.empty(2 * n, dtype=np.float64)
            inter[0::2] = np.asarray(label)[:n]
            inter[1::2] = out
            self._f.write(("%g\t%g\n" * n) % tuple(inter))
        else:
            self._f.write(("%g\n" * n) % tuple(out))

    def close(self) -> None:
        self._f.close()


@dataclass
class DumpParam(Param):
    """src/reader/dump.h:12-31."""
    updater: str = "sgd"
    model_in: str = ""
    name_dump: str = "dump.txt"
    need_reverse: bool = False
    dump_aux: bool = False


def run_dump(kwargs: KWArgs, device="cuda") -> KWArgs:
    """task=dump: open ``model_in`` in a store of its own ``V_dim`` (read
    from the checkpoint) with its optimizer state, and write the TSV."""
    import dataclasses

    from .store.local import SlotStore
    from .updaters.sgd_updater import SGDUpdaterParam
    from .utils import stream

    param, remain = DumpParam.init_allow_unknown(kwargs)
    if not param.model_in:
        raise ValueError("please set model_in")
    if param.updater != "sgd":
        raise ValueError(f"unknown updater: {param.updater}")
    with stream.load_npz(param.model_in) as z:
        v_dim = int(z["V_dim"]) if "V_dim" in z.files else 0
    uparam, remain = SGDUpdaterParam.init_allow_unknown(remain)
    store = SlotStore(dataclasses.replace(uparam, V_dim=v_dim),
                      device=device)
    store.load(param.model_in)
    n = store.dump(param.name_dump, param.dump_aux, param.need_reverse)
    log.info("dumped %d features to %s", n, param.name_dump)
    return remain


def run_pred(kwargs: KWArgs, device="cuda", store=None) -> KWArgs:
    """task=pred: slice the reader's blocks into ``batch_size`` windows
    and score each through the predict executor (the JAX learner's
    ``_run_pred_executor``). ``store`` reuses an already-open serving
    store; otherwise ``model_in`` is opened on ``device``. Logs the
    objective and AUC per row; returns the unconsumed kwargs."""
    from .data.reader import Reader
    from .losses import create as create_loss
    from .serve.executor import PredictExecutor
    from .serve.model import open_serving_store

    p, remain = PredParam.init_allow_unknown(kwargs)
    mp, remain = PredMeshParam.init_allow_unknown(remain)
    if store is None:
        if not p.model_in:
            raise ValueError("prediction needs model_in")
        mesh = None
        if mp.mesh_dp * mp.mesh_fs > 1 or mp.mesh_force:
            from .parallel import make_mesh
            mesh = make_mesh(dp=mp.mesh_dp, fs=mp.mesh_fs, device=device)
        store, _, remain = open_serving_store(p.model_in, remain,
                                              device=device, mesh=mesh)
    ex = PredictExecutor(store, loss=create_loss(p.loss, store.param.V_dim))
    writer = PredWriter(f"{p.pred_out}_part-0", p.pred_prob) \
        if p.pred_out else None
    n_rows, objv, auc = 0, 0.0, 0.0
    try:
        for blk in Reader(p.data_val or p.data_in, p.data_format,
                          chunk_bytes=256 << 20):
            for s in range(0, blk.size, p.batch_size):
                sub = blk.slice(s, min(s + p.batch_size, blk.size))
                scores, o, a = ex.predict(sub)
                if writer is not None:
                    writer.write(scores, sub.label)
                n_rows += sub.size
                objv += float(o)
                auc += float(a)
    finally:
        if writer is not None:
            writer.close()
    log.info("prediction: %d rows, objv %.6f, auc %.6f", n_rows,
             objv / max(n_rows, 1), auc / max(n_rows, 1))
    return remain


def main(argv: Optional[list] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s %(message)s")
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m difacto_tpu_torch [config_file] "
              "task=train|pred|serve|online|dump|convert key1=val1 ...",
              file=sys.stderr)
        return 1
    param, remain = DifactoParam.init_allow_unknown(parse_cli_args(argv))
    if param.task == "pred":
        if param.learner != "sgd":
            raise _pred_routing_error(param.learner, remain)
        warn_unknown(run_pred(remain, device=param.device))
    elif param.task == "serve":
        from .serve import run_serve
        warn_unknown(run_serve(remain, device=param.device))
    elif param.task == "train":
        from .learners.base import Learner
        learner = Learner.create(param.learner, device=param.device)
        warn_unknown(learner.init(remain))
        learner.run()
    elif param.task == "dump":
        warn_unknown(run_dump(remain, device=param.device))
    elif param.task == "convert":
        from .data.converter import Converter
        conv = Converter()
        warn_unknown(conv.init(remain))
        conv.run()
    elif param.task == "online":
        from .online import run_online
        warn_unknown(run_online(remain, device=param.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
