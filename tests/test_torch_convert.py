"""``python -m difacto_tpu_torch task=convert`` and ``task=dump`` against
the JAX package's, byte for byte (tolerance 0).

convert: the same member files (names and bytes) as JAX's converter for
the same input and parameters: rec2 and npz members, localized and not,
serial and with ``convert_procs=2`` (the JAX side of the parallel case
runs its ``convert_part_iter`` for each part in this process: that is
what its worker processes run, and its ring segments would otherwise
share /dev/shm with the JAX suite's own leak checks), the libsvm output
from text and from a rec cache, ``part_size`` splitting, and the
``stats`` dict. An npz member is a zip whose entries stamp their write
time, so npz members are compared entry by entry (name, compression,
bytes), rec2 members and text as whole files.

dump: the TSV of one checkpoint equals JAX's for the hashed store (fp32,
bf16 and int8 tables), the dictionary store (``need_reverse`` on and
off) and the flat V_dim=0 table, with and without ``dump_aux``.
"""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from difacto_tpu.__main__ import run_dump as jrun_dump
from difacto_tpu.data import converter as jconv
from difacto_tpu_torch.__main__ import main
from difacto_tpu_torch.data import converter as tconv

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
sys.path.insert(0, _ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402

RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert")
    (d / "train.txt").write_bytes(synthetic_criteo(300, 41))
    return str(d / "train.txt")


def _entries(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, i.compress_type, z.read(i))
                for i in z.infolist()]


def assert_same_tree(got, want):
    """Two convert outputs hold the same files with the same contents."""
    if os.path.isfile(want):
        with open(got, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read(), got
        return
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and names
    for n in names:
        a, b = os.path.join(got, n), os.path.join(want, n)
        if n.endswith(".npz"):
            assert _entries(a) == _entries(b), n
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), n


def _jax_convert(args):
    conv = jconv.Converter()
    assert conv.init(args) == []
    conv.run()
    return conv


CASES = {
    "rec2 localized": [("rec_batch_size", "25")],
    "rec2 raw": [("rec_localize", "0"), ("batch_size", "30")],
    "npz localized": [("rec_encoding", "npz"), ("rec_batch_size", "40")],
    "npz compressed raw": [("rec_encoding", "npz"), ("rec_compress", "1"),
                           ("rec_localize", "0"), ("rec_batch_size", "40")],
    "one member per chunk": [("rec_batch_size", "-1")],
    "default member rows": [],
    "part_size": [("part_size", "1"), ("rec_batch_size", "1")],
    "threads": [("convert_threads", "3"), ("rec_batch_size", "7")],
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("data", ["rcv1", "criteo"])
def test_serial_convert_writes_the_jax_members(tmp_path, criteo, case,
                                               data):
    src, fmt = (RCV1, "libsvm") if data == "rcv1" else (criteo, "criteo")
    base = [("data_in", src), ("data_format", fmt),
            ("data_out_format", "rec"), ("convert_procs", "1")] + CASES[case]
    want = _jax_convert(base + [("data_out", str(tmp_path / "j.rec"))])
    port = tconv.Converter()
    assert port.init(base + [("data_out", str(tmp_path / "p.rec"))]) == []
    port.run()
    assert port.num_rows == want.num_rows == (100 if data == "rcv1" else 300)
    assert set(port.stats) == set(want.stats)
    if case != "part_size":
        assert_same_tree(str(tmp_path / "p.rec"), str(tmp_path / "j.rec"))
        return
    # a part rolls over once the bytes of the writes that have landed
    # pass part_size, so where it does depends on the write threads'
    # timing, in both packages; the members, in order, do not
    def members(prefix):
        parts = sorted((n for n in os.listdir(tmp_path)
                        if n.startswith(prefix)),
                       key=lambda n: int(n.rsplit("_", 1)[1]))
        return [open(tmp_path / d / m, "rb").read() for d in parts
                for m in sorted(os.listdir(tmp_path / d))]
    got, ref = members("p.rec-part_"), members("j.rec-part_")
    assert got == ref and len(got) == port.num_rows
    assert (tmp_path / "p.rec-part_1").is_dir()     # it did split


@pytest.mark.parametrize("encoding,localize", [("rec2", 1), ("npz", 0)])
def test_parallel_convert_writes_the_jax_members(tmp_path, criteo, encoding,
                                                 localize):
    """convert_procs=2 through the port's CLI (two worker processes)
    against the members JAX's two workers write."""
    out = str(tmp_path / "p.rec")
    assert main(["task=convert", f"data_in={criteo}", "data_format=criteo",
                 f"data_out={out}", "data_out_format=rec",
                 "convert_procs=2", "batch_size=40",
                 f"rec_encoding={encoding}", f"rec_localize={localize}"]) == 0
    ref = jconv.Converter()
    ref.init([("data_in", criteo), ("data_format", "criteo"),
              ("data_out", str(tmp_path / "j.rec")),
              ("data_out_format", "rec"), ("convert_procs", "2"),
              ("batch_size", "40"), ("rec_encoding", encoding),
              ("rec_localize", str(localize))])
    p = ref.param
    spec = jconv._ConvertSpec(
        data_in=p.data_in, data_format=p.data_format,
        out_dir=ref._open_rec_part(0, False),
        member_suffix=ref.member_suffix(), member_rows=ref.member_rows(),
        rec_localize=p.rec_localize, rec_compress=p.rec_compress,
        chunk_bytes=min(int(p.chunk_size * (1 << 20)), 32 << 20),
        n_parts=2)
    rows = sum(item[1] for part in range(2)
               for item in jconv.convert_part_iter(spec, part))
    assert rows == 300
    assert_same_tree(out, str(tmp_path / "j.rec"))
    assert any(n.startswith("part-001-") for n in os.listdir(out))


def test_parallel_convert_stats_and_auto_rule(tmp_path, monkeypatch):
    conv = tconv.Converter()
    conv.init([("data_in", RCV1), ("data_format", "libsvm"),
               ("data_out", str(tmp_path / "p.rec")),
               ("data_out_format", "rec"), ("convert_procs", "2"),
               ("rec_batch_size", "25")])
    conv.run()
    assert conv.stats["procs"] == 2 and conv.stats["rows"] == 100
    assert conv.stats["members"] == len(os.listdir(tmp_path / "p.rec"))
    # the auto rule, as JAX's: min(cores, 8) on >= 4 cores, else 1; one
    # process for part_size splitting and the libsvm output
    for ncpu, want in ((1, 1), (3, 1), (4, 4), (8, 8), (64, 8)):
        monkeypatch.setattr(os, "cpu_count", lambda n=ncpu: n)
        for extra, w in (([], want), ([("part_size", "1")], 1),
                         ([("data_out_format", "libsvm")], 1)):
            args = [("data_in", RCV1), ("data_format", "libsvm"),
                    ("data_out", "x"), ("data_out_format", "rec")] + extra
            got, ref = tconv.Converter(), jconv.Converter()
            got.init(args)
            ref.init(args)
            assert got.resolve_procs() == ref.resolve_procs() == w


@pytest.mark.parametrize("source", ["libsvm", "rec", "criteo", "adfea"])
def test_libsvm_output_matches_jax(tmp_path, criteo, source):
    if source == "rec":
        src = str(tmp_path / "in.rec")
        _jax_convert([("data_in", RCV1), ("data_format", "libsvm"),
                      ("data_out", src), ("data_out_format", "rec"),
                      ("rec_batch_size", "30"), ("convert_procs", "1")])
    elif source == "adfea":
        src = str(tmp_path / "in.adfea")
        rng = np.random.RandomState(4)
        with open(src, "w") as f:
            for i in range(60):
                feats = " ".join(f"{rng.randint(0, 1 << 30)}:"
                                 f"{rng.randint(0, 5000)}"
                                 for _ in range(rng.randint(1, 8)))
                f.write(f"{i} 1 {rng.randint(0, 2)} {feats}\n")
    else:
        src = RCV1 if source == "libsvm" else criteo
    args = [("data_in", src), ("data_format", source),
            ("data_out_format", "libsvm")]
    _jax_convert(args + [("data_out", str(tmp_path / "j.txt"))])
    port = tconv.Converter()
    port.init(args + [("data_out", str(tmp_path / "p.txt"))])
    port.run()
    assert_same_tree(str(tmp_path / "p.txt"), str(tmp_path / "j.txt"))


def test_cli_subprocess_converts_and_reads_back(tmp_path):
    out = str(tmp_path / "cli.rec")
    r = subprocess.run(
        [sys.executable, "-m", "difacto_tpu_torch", "task=convert",
         f"data_in={RCV1}", "data_format=libsvm", f"data_out={out}",
         "data_out_format=rec", "batch_size=50", "convert_procs=1"],
        cwd=_ROOT, env=dict(os.environ, PYTHONPATH=_ROOT),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert sorted(os.listdir(out)) == ["part-00000.rec2", "part-00001.rec2"]
    with pytest.raises(ValueError, match="requires data_out"):
        main(["task=convert", f"data_in={RCV1}", "data_format=libsvm",
              "data_out_format=rec"])
    with pytest.raises(ValueError, match="rec_encoding"):
        main(["task=convert", f"data_in={RCV1}", "data_format=libsvm",
              f"data_out={out}", "data_out_format=rec",
              "rec_encoding=zip"])


# ----------------------------------------------------------------- dump
def _train_model(tmp_path, store):
    """A small trained port checkpoint with its optimizer state."""
    model = str(tmp_path / f"m_{store}")
    args = ["task=train", "device=cpu", f"data_in={RCV1}",
            "max_num_epochs=2", "batch_size=20", "l1=0.1", "lr=0.1",
            "V_threshold=1", "report_interval=0", "has_aux=1",
            f"model_out={model}"]
    if store == "flat":
        args += ["loss=logit", "init_capacity=64"]
    else:
        args += ["V_dim=3"]
        args += ["hash_capacity=4096"] if store == "hashed" \
            else ["init_capacity=64"]
    assert main(args) == 0
    return model + "_part-0"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("dump")
    return {s: _train_model(d, s) for s in ("hashed", "dictionary", "flat")}


@pytest.mark.parametrize("store,extra", [
    ("hashed", []), ("hashed", ["slot_dtype=bf16"]),
    ("hashed", ["slot_dtype=int8"]), ("dictionary", []),
    ("dictionary", ["need_reverse=1"]), ("flat", [])])
@pytest.mark.parametrize("aux", [0, 1])
def test_dump_is_the_jax_tsv(tmp_path, models, store, extra, aux):
    model = models[store]
    kw = [f"model_in={model}", f"dump_aux={aux}"] + extra
    if store == "hashed":
        kw.append("hash_capacity=4096")
    got, want = str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv")
    assert main(["task=dump", "device=cpu", f"name_dump={got}"] + kw) == 0
    assert jrun_dump([tuple(a.split("=", 1)) for a in
                      kw + [f"name_dump={want}"]]) == []
    with open(got, "rb") as f, open(want, "rb") as g:
        text, ref = f.read(), g.read()
    lines = text.splitlines()
    assert lines
    ncols = {len(x.split(b"\t")) for x in lines}
    assert ncols <= {3 + 2 * aux, 3 + 2 * aux + 3 * (1 + aux)}
    if "slot_dtype=bf16" in extra:
        # the scalars ride a bf16 row as two 16-bit halves; the port
        # keeps the checkpoint's bits, so they are the fp32 table's dump
        main(["task=dump", "device=cpu", f"name_dump={got}.f32"]
             + [a for a in kw if a not in extra])
        with open(got + ".f32", "rb") as f:
            f32 = f.read().splitlines()
        n_scal = 3 + 2 * aux
        assert [x.split(b"\t")[:n_scal] for x in lines] == \
            [x.split(b"\t")[:n_scal] for x in f32]
        # JAX on the CPU canonicalizes a half that reads as a bf16 NaN
        # (ROADMAP.md Queue 3): hold the port to JAX through that rule
        text = b"\n".join(_canonical_halves(x, n_scal)
                          for x in lines) + b"\n"
    assert text == ref


def _canonical_halves(line: bytes, n_scal: int) -> bytes:
    """``line`` with each scalar column's low 16 bits set to the bf16
    canonical NaN (sign kept) where they read as a bf16 NaN, as JAX's
    CPU build of a bf16 row does."""
    cols = line.split(b"\t")
    for i in range(2, n_scal):
        bits = int(np.float32(float(cols[i])).view(np.uint32))
        lo = bits & 0xFFFF
        if lo & 0x7FFF > 0x7F80:
            bits = (bits & 0xFFFF8000) | 0x7FC0
            cols[i] = repr(float(np.uint32(bits).view(np.float32))).encode()
    return b"\t".join(cols)


def test_dump_requires_model_in_and_names_online_as_not_ported():
    # task=online is ported now: without its log directory it raises
    # the JAX package's ValueError, not NotImplementedError
    with pytest.raises(ValueError, match="model_in"):
        main(["task=dump", "device=cpu"])
    with pytest.raises(ValueError, match="online_log_dir"):
        main(["task=online", "device=cpu"])
