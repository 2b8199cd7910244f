"""The reference's frozen copies equal the program's functions today, at
a tiny size: the hash from a Criteo field to a slot, the V
initialisation, and the learner's batch order on its first and replayed
epochs. A change in the program shows here when it happens."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import gen, harness
from benchmark.check import token_slots
from benchmark.reference import batches, init
from difacto_tpu_torch.base import reverse_bytes
from difacto_tpu_torch.data.batch_reader import BatchReader
from difacto_tpu_torch.data.native_parsers import parse_criteo_native
from difacto_tpu_torch.data.parsers import parse_criteo
from difacto_tpu_torch.learners.sgd import _DeviceBatchCache
from difacto_tpu_torch.store.slots import hash_slots
from difacto_tpu_torch.updaters.sgd_updater import (SGDUpdaterParam,
                                                     init_V_rows)


def _rows(n, seed, traffic="replay_b65k_kaggle"):
    return gen.make_rows(harness.load_traffic(traffic), n, seed)


@pytest.mark.parametrize("traffic", ["replay_b65k_kaggle", "replay_b65k_1tb"])
def test_hash_rule_is_the_parsers(traffic):
    rows = _rows(700, 2 ** 31 + 17, traffic)
    text = gen.criteo_text(rows)
    cap = 1 << 22
    mine = token_slots(rows, cap, "cpu").numpy()
    for parse in (parse_criteo, parse_criteo_native):
        blk = parse(text)
        np.testing.assert_array_equal(blk.label, rows["labels"])
        got = hash_slots(reverse_bytes(blk.index), cap)
        np.testing.assert_array_equal(got, mine[mine >= 0])
        np.testing.assert_array_equal(np.diff(blk.offset),
                                      (mine >= 0).sum(1))


def test_init_is_the_tables():
    p = SGDUpdaterParam(V_dim=16, seed=(2 ** 31 + 5) & 0xFFFFFFFF,
                        V_init_scale=0.01)
    want = init_V_rows(p, 70000, 70100, torch.device("cpu"))
    got = init.init_V(torch.arange(70000, 70100), 16, 2 ** 31 + 5, 0.01)
    assert torch.equal(want, got)


def test_batch_order_is_the_readers(tmp_path):
    n, bs, shuffle = 5000, 256, 3
    rows = _rows(n, 4)
    path = tmp_path / "rows.criteo"
    path.write_bytes(gen.criteo_text(rows))
    order = batches.epoch0_batches(n, bs, shuffle)
    # a row's label and first integer field name it well enough here
    key = rows["ints"][:, 0] * 2 + rows["labels"]
    got = list(BatchReader(str(path), "criteo", 0, 1, bs, bs * shuffle,
                           1.0, seed=0))
    assert [b.size for b in got] == [len(o) for o in order]
    for blk, o in zip(got, order):
        np.testing.assert_array_equal(blk.label, rows["labels"][o])
    assert len(set(key)) > 1
    cache = _DeviceBatchCache(1 << 10)
    cache.entries[0] = list(range(len(order)))
    replay = [i for _, i in cache.iter_parts(True, seed=1)]
    np.testing.assert_array_equal(replay,
                                  batches.replay_order(len(order), 1, 3))
