"""The data-parallel mesh repeats bit for bit run to run (ROADMAP Queue 3:
the 2 x 4 mesh's COO run).

A batch is padded to sticky caps (``ShapeSchedule.cap``) that grow with
the batches the producers packed before it, so the same batch can get
another cap in another run. The backward's dp blocks are cut from the
batch's real rows (``losses/fm.dp_blocks``), never from the cap, so its
per-slot partials, and the table, are the same bits whatever cap the
batch was given:

- rcv1's COO rows on the examples' 2 x 4 mesh and on ``mesh_dp=2``
  alone, three runs each in one process: the three tables and the
  per-epoch rows are bit-identical (a cut at the cap alternated from
  the second run on);
- the backward of one batch at two nnz caps, and of one panel at two
  row caps, under dp=2 and dp=4: the same bits as each other.
"""

import numpy as np
import pytest
import torch

from difacto_tpu_torch.losses.fm import (FMParams, fm_grad, fm_grad_panel,
                                         fm_predict_xv,
                                         fm_predict_panel_xv)
from difacto_tpu_torch.ops.batch import DeviceBatch, PanelBatch
from difacto_tpu_torch.parallel import sharded

from test_torch_dp_sharding import rcv1_kwargs, run_port


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")


def _bits(ln) -> np.ndarray:
    return sharded.host_state(ln.store.state).VVg.contiguous().view(
        torch.int32).numpy().copy()


@pytest.mark.parametrize("mesh", [[("mesh_dp", "2"), ("mesh_fs", "4")],
                                  [("mesh_dp", "2")]],
                         ids=["dp2_fs4", "dp2"])
def test_three_runs_in_one_process_are_bit_identical(tmp_path, mesh):
    kw = rcv1_kwargs(("hash_capacity", "4096")) + mesh
    runs = [run_port(kw, str(tmp_path / f"m{i}")) for i in range(3)]
    assert runs[0][2].loss.dp == 2
    first_rows, first = runs[0][0], _bits(runs[0][2])
    for i, (rows, _, ln) in enumerate(runs[1:], 1):
        assert rows == first_rows, i
        differ = int((_bits(ln) != first).sum())
        assert differ == 0, f"run {i}: {differ} words of VVg differ"


def _params(U: int, k: int, seed: int) -> FMParams:
    g = np.random.RandomState(seed)
    return FMParams(
        w=torch.from_numpy(g.randn(U).astype(np.float32)),
        V=torch.from_numpy((0.1 * g.randn(U, k)).astype(np.float32)),
        v_mask=torch.from_numpy((g.rand(U) > 0.2).astype(np.float32)))


def _coo(rows_nnz, U: int, nnz_cap: int, b_cap: int, seed: int):
    """One ragged batch packed as ops/batch.pack_batch packs it: pad
    entries in the last real row, value 0, column 0."""
    g = np.random.RandomState(seed)
    b = len(rows_nnz)
    nnz = int(sum(rows_nnz))
    rows = np.full(nnz_cap, b - 1, np.int32)
    rows[:nnz] = np.repeat(np.arange(b), rows_nnz)
    cols = np.zeros(nnz_cap, np.int32)
    cols[:nnz] = g.randint(0, U, nnz)
    vals = np.zeros(nnz_cap, np.float32)
    vals[:nnz] = g.rand(nnz).astype(np.float32) + 0.5
    labels = np.zeros(b_cap, np.float32)
    labels[:b] = g.randint(0, 2, b)
    mask = np.zeros(b_cap, np.float32)
    mask[:b] = 1
    t = torch.from_numpy
    return DeviceBatch(rows=t(rows), cols=t(cols), vals=t(vals),
                       labels=t(labels), rweight=t(mask.copy()),
                       row_mask=t(mask), num_rows=torch.tensor(b),
                       num_uniq=torch.tensor(U),
                       row_cap=int(max(rows_nnz)))


def _same_bits(a, b) -> bool:
    return a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("dp", [2, 4])
def test_coo_backward_does_not_move_with_the_nnz_cap(dp):
    U, k = 64, 4
    params = _params(U, k, 1)
    lens = np.random.RandomState(2).randint(1, 9, 30)
    grads = []
    for nnz_cap in (int(lens.sum()) + 8 * dp, 2 * int(lens.sum())):
        nnz_cap -= nnz_cap % dp
        for b_cap in (32, 48):
            batch = _coo(lens, U, nnz_cap, b_cap, 3)
            pred, xv = fm_predict_xv(params, batch)
            grads.append(fm_grad(params, batch, pred, xv, dp=dp))
    for gw, gV in grads[1:]:
        assert _same_bits(gw, grads[0][0]) and _same_bits(gV, grads[0][1])


def _panel(b: int, F: int, U: int, b_cap: int, seed: int):
    g = np.random.RandomState(seed)
    idx = np.zeros((b_cap, F), np.int32)
    idx[:b] = g.randint(0, U, (b, F))
    vals = np.zeros((b_cap, F), np.float32)
    vals[:b] = g.rand(b, F).astype(np.float32) + 0.5
    labels = np.zeros(b_cap, np.float32)
    labels[:b] = g.randint(0, 2, b)
    mask = np.zeros(b_cap, np.float32)
    mask[:b] = 1
    t = torch.from_numpy
    return PanelBatch(idx=t(idx), vals=t(vals), labels=t(labels),
                      rweight=t(mask.copy()), row_mask=t(mask),
                      num_rows=torch.tensor(b), num_uniq=torch.tensor(U))


@pytest.mark.parametrize("dp", [2, 4])
def test_panel_backward_does_not_move_with_the_row_cap(dp):
    U, k = 64, 4
    params = _params(U, k, 4)
    grads = []
    for b_cap in (40, 64, 96):
        pb = _panel(37, 6, U, b_cap, 5)
        pred, xv = fm_predict_panel_xv(params, pb)
        grads.append(fm_grad_panel(params, pb, pred, xv, dp=dp))
    for gw, gV in grads[1:]:
        assert _same_bits(gw, grads[0][0]) and _same_bits(gV, grads[0][1])
