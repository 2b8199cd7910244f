"""The harness finds what a cell names and refuses what it does not
know; the generator is the traffic file's; the yardstick counts by hand;
nothing of the benchmark imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest

from benchmark import gen, harness, yardstick as ys

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    cell = harness.find_cell(workload)
    assert cell.cfg["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == workload)
    assert cell.traffic["int_fields"] + cell.traffic["cat_fields"] == 39
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    cfg = harness.load_json(harness.ROOT / config["file"])
    assert cfg["name"] == config["name"]
    assert set(config["reduced"]) == set(cfg["reduced"])
    assert cfg["source"] and cfg["deployment"] and cfg["assumed"]
    assert set(cfg["check"]["limits"]) == {"loss_gap", "grad_gap",
                                           "change_gap"}


@pytest.mark.parametrize("what,call", [
    ("workload", lambda: harness.find_cell("fm16.nope")),
    ("traffic", lambda: harness.load_traffic("nope")),
    ("metric", lambda: harness.metric_reader("nope_ms")),
])
def test_unknown_names_refused(what, call):
    with pytest.raises(KeyError):
        call()


def test_bad_configuration_refused(tmp_path):
    spec = dict(SPEC, workloads=[dict(SPEC["workloads"][0], config="x")])
    p = tmp_path / "BENCHMARK.json"
    p.write_text(json.dumps(spec))
    with pytest.raises(KeyError):
        harness.find_cell(SPEC["workloads"][0]["name"], p)


TRAFFIC = sorted({w["traffic"] for w in SPEC["workloads"]})


@pytest.mark.parametrize("name", TRAFFIC)
def test_generator_per_seed(name):
    tr = harness.load_traffic(name)
    n = 20000
    a, b = gen.make_rows(tr, n, 2 ** 31 + 3), gen.make_rows(tr, n, 2 ** 31 + 3)
    c = gen.make_rows(tr, n, 2 ** 31 + 4)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["cats"], c["cats"])
    assert a["ints"].shape == (n, 13) and a["cats"].shape == (n, 26)
    assert a["empty"].shape == (n, 39)
    # each field empty at its own share
    np.testing.assert_allclose(a["empty"].mean(0), tr["empty_share"],
                               atol=0.015)
    assert a["ints"].min() >= 0 and a["ints"].max() <= tr["int_cap"] - 1
    field = a["cats"] // gen.CAT_FIELD_SPAN
    np.testing.assert_array_equal(field, np.arange(26)[None, :].repeat(
        n, 0))
    # each categorical field within its own cardinality, and the small
    # ones take every value
    value = a["cats"] % gen.CAT_FIELD_SPAN
    card = np.asarray(tr["cat_cardinality"])
    assert (value.min(0) >= 1).all() and (value.max(0) <= card).all()
    small = card <= 30
    assert small.any()
    for f in np.flatnonzero(small):
        assert len(np.unique(value[:, f])) == card[f]
    assert 0.2 < a["labels"].mean() < 0.32


def test_power_law_truncated():
    rng = np.random.default_rng(5)
    x = gen.power_law(rng, (200000, 2), 1.2, np.array([3, 10 ** 7]))
    assert x.min() >= 1 and x[:, 0].max() == 3 and x[:, 1].max() <= 10 ** 7
    # P(X >= 2) over the truncated law: (2^-0.2 - 4^-0.2) / (1 - 4^-0.2)
    want = (2 ** -0.2 - 4 ** -0.2) / (1 - 4 ** -0.2)
    assert abs((x[:, 0] >= 2).mean() - want) < 0.01


def test_generator_text_is_the_loop():
    rows = gen.make_rows(harness.load_traffic(TRAFFIC[0]), 300, 9)
    lines = []
    for i in range(300):
        f = [str(v) for v in rows["ints"][i]] + [
            format(v, "08x") for v in rows["cats"][i]]
        f = ["" if e else s for s, e in zip(f, rows["empty"][i])]
        lines.append(str(rows["labels"][i]) + "\t" + "\t".join(f))
    assert gen.criteo_text(rows) == ("\n".join(lines) + "\n").encode()
    assert gen.token_count(rows) == int((~rows["empty"]).sum())


def test_row_layouts():
    conf16 = harness.load_json(
        harness.ROOT / "benchmark/configs/criteo_kaggle_fm16.json")["conf"]
    conf64 = harness.load_json(
        harness.ROOT / "benchmark/configs/criteo_1tb_fm64.json")["conf"]
    assert ys.row_bytes(conf16) == 512
    assert ys.row_bytes(conf64) == 1024
    small = dict(conf16, hash_capacity=1 << 16)
    assert ys.row_bytes(small) == 512       # padded halves of 64 lanes
    assert ys.row_layout(dict(small, slot_dtype="bf16"))[1:] == (128, 2)


def test_counts_by_hand():
    # a batch of 2 rows, 5 tokens, 3 in-bounds slots of 4 with 2 active,
    # k = 2, rows of 64 B; the padded 4th slot counts nothing
    assert ys.step_bytes(5, 2, 3, 64) == 2 * 3 * 64 + 4 * 5 + 4 * 3 + 4 * 2
    assert ys.gather_bytes(3, 64) == 3 * (64 + 64 + 4)
    assert ys.push_bytes(3, 2, 2, 64) == 3 * (64 + 64 + 4 + 4 + 4) + 2 * 8
    fl = 5 * (1 + 6) + 2 * (6 + 8) + 5 * 3 + 2 * 6 + 3 * 15 + 2 * 16
    assert ys.step_flops(5, 2, 3, 2, 2) == fl
    assert ys.least_seconds(fl, 0) == fl / 67e12
    assert ys.least_seconds(0, 3.35e12) == 1.0


def test_shares_refuse_the_cpu():
    with pytest.raises(ValueError):
        ys.share(1.0, 2.0, "cpu")
    assert ys.share(1.0, 2.0, "cuda") == 50.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imported():
    files = sorted((harness.ROOT / "benchmark").rglob("*.py"))
    assert files
    bad = {"jax", "jaxlib", "flax", "difacto_tpu"}
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in bad, (f, name)


def test_trace_attributes_by_launch_only():
    from benchmark import run, traceread as trd
    E = trd.Event
    events = [E("bench.window", False, 0, 1000, 0),
              E("bench.kernels.gather", False, 100, 150, 0),
              E("cudaLaunchKernel", False, 110, 120, 7),
              E("gather_rows_kernel", True, 200, 260, 7),
              # a kernel of the same name that no launch links: counted
              # as device time, never as the entry's
              E("gather_rows_kernel", True, 300, 340, 8),
              E("scatter_epilogue", True, 400, 450, 9)]
    t = trd.analyze(events, run.KERNEL_SPANS, run.HOST_SPANS)
    assert t["entry_s"] == {"gather": 60e-9}
    assert t["busy_s"] == 150e-9 and t["window_s"] == 1000e-9
    reader = harness.metric_reader("push_roofline.replay")
    ctx = {"device": "cuda", "trace": t, "conf": {},
           "traced": {"calls": {}}}
    assert reader(ctx) is None
    assert harness.metric_reader("step_device_ms.replay")(
        dict(ctx, traced={"steps": 1})) is None
