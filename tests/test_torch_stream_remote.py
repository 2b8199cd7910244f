"""Remote streams of the port (``utils/stream.py`` over fsspec) against
the JAX package's, on fsspec's ``memory://`` filesystem (the counterpart
of tests/test_stream.py).

- The helpers list, size, glob, move and delete remote objects as JAX's
  do; local paths never import fsspec.
- An npz saved to ``memory://`` by either package is the other's npz:
  the same zip entries byte for byte and the same manifest, no ``.tmp``
  left behind; either package loads the other's.
- The Reader over a remote text file yields the local file's blocks.
- Training with a remote ``data_in`` and ``model_out`` writes the local
  run's model byte for byte, JAX's store loads it, and ``task=pred`` of
  the remote model into a remote ``pred_out`` writes the local bytes.
- ``task=convert`` to ``memory://`` (``convert_procs=1`` on both sides)
  writes JAX's rec2 and npz members byte for byte, and training from the
  remote cache equals training from the local one.
- The JAX package's converter loses the members of a ``memory://``
  output once it uses worker processes (each writes into its own
  process's memory; its auto rule picks 8 on a host with 8 cores); the
  port converts a ``memory://`` output in one process and keeps them.
"""

import os
import sys
import zipfile

import numpy as np
import pytest

fsspec = pytest.importorskip("fsspec")

from difacto_tpu.data import converter as jconv  # noqa: E402
from difacto_tpu.data.reader import Reader as JReader  # noqa: E402
from difacto_tpu.utils import manifest as jmft  # noqa: E402
from difacto_tpu.utils import stream as jstream  # noqa: E402
from difacto_tpu_torch.__main__ import main  # noqa: E402
from difacto_tpu_torch.data import converter as tconv  # noqa: E402
from difacto_tpu_torch.data.reader import Reader  # noqa: E402
from difacto_tpu_torch.utils import manifest as tmft  # noqa: E402
from difacto_tpu_torch.utils import stream  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402

RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")


@pytest.fixture
def memfs():
    fs = fsspec.filesystem("memory")
    yield fs
    try:
        fs.rm("/", recursive=True)
    except FileNotFoundError:
        pass


def _put(uri, path):
    with open(path, "rb") as f, stream.open_stream(uri, "wb") as g:
        g.write(f.read())


def _get(uri) -> bytes:
    with stream.open_stream(uri, "rb") as f:
        return f.read()


def _entries(data: bytes):
    import io
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return [(i.filename, i.compress_type, z.read(i))
                for i in z.infolist()]


def test_helpers_match_jax(memfs):
    for mod, d in ((stream, "t"), (jstream, "j")):
        for name, body in (("a.txt", b"hello\nworld\n"), ("b.bin", b"xy")):
            with mod.open_stream(f"memory://{d}/dir/{name}", "wb") as f:
                f.write(body)
        mod.makedirs(f"memory://{d}/dir/sub")
    for fn in ("listdir", "listdir_files"):
        got = getattr(stream, fn)("memory://t/dir")
        want = getattr(jstream, fn)("memory://j/dir")
        assert [str(g).replace("/t/", "/j/") for g in got] \
            == [str(w) for w in want], fn
    assert stream.glob("memory://t/dir/*.txt") == ["memory://t/dir/a.txt"]
    uri = "memory://t/dir/a.txt"
    assert stream.is_remote(uri) and not stream.is_remote("file:///x")
    assert stream.exists(uri) and stream.isfile(uri)
    assert stream.isdir("memory://t/dir") and not stream.isfile("memory://t")
    assert stream.getsize(uri) == jstream.getsize("memory://j/dir/a.txt")
    assert stream.getmtime(uri) == jstream.getmtime(uri) > 0
    assert stream.join("memory://t/dir/", "a.txt") == uri
    assert _get(uri) == b"hello\nworld\n"
    stream.remove(uri)
    assert not stream.exists(uri)


def test_local_paths_need_no_fsspec(tmp_path):
    import subprocess
    code = ("import sys\n"
            "class P:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] == 'fsspec':\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, P())\n"
            "import numpy as np\n"
            "from difacto_tpu_torch.utils import stream\n"
            f"p = {str(tmp_path / 'a.npz')!r}\n"
            "stream.save_npz(p, manifest={'generation': 1}, a=np.arange(3))\n"
            "with stream.load_npz(p) as z:\n"
            "    assert z['a'].tolist() == [0, 1, 2]\n"
            "try:\n"
            "    stream.exists('memory://x')\n"
            "except ImportError as e:\n"
            "    assert 'fsspec' in str(e)\n"
            "else:\n"
            "    raise SystemExit('fsspec was found')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       env=dict(os.environ, PYTHONPATH=_ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("compress", [False, True])
def test_npz_round_trip_is_jax_bytes(memfs, compress):
    arrays = dict(a=np.arange(10, dtype=np.float32), b=np.array(3),
                  V=np.linspace(-1, 1, 24, dtype=np.float32).reshape(6, 4))
    man = {"learner": "sgd", "rows": 6, "generation": 2}
    stream.save_npz("memory://t/ck.npz", manifest=dict(man),
                    compress=compress, **arrays)
    jstream.save_npz("memory://j/ck.npz", manifest=dict(man),
                     compress=compress, **arrays)
    for d in ("t", "j"):
        names = [p.rsplit("/", 1)[-1] for p in stream.listdir(f"memory://{d}")]
        assert names == ["ck.npz", "ck.npz.manifest.json"], names
    assert _entries(_get("memory://t/ck.npz")) \
        == _entries(_get("memory://j/ck.npz"))
    assert _get("memory://t/ck.npz.manifest.json") \
        == _get("memory://j/ck.npz.manifest.json")
    # each package verifies and loads the other's object
    assert jmft.verify("memory://t/ck.npz", require_manifest=True) \
        == tmft.verify("memory://j/ck.npz", require_manifest=True)
    for uri, load in (("memory://t/ck.npz", jstream.load_npz),
                      ("memory://j/ck.npz", stream.load_npz)):
        with load(uri) as z:
            for k, v in arrays.items():
                np.testing.assert_array_equal(z[k], v)


def test_reader_over_a_remote_file_yields_the_local_blocks(memfs):
    _put("memory://data/rcv1.libsvm", RCV1)
    for part in range(3):
        local = list(Reader(RCV1, "libsvm", part, 3))
        remote = list(Reader("memory://data/rcv1.libsvm", "libsvm", part, 3))
        jremote = list(JReader("memory://data/rcv1.libsvm", "libsvm",
                               part, 3))
        for got in (remote, jremote):
            assert len(got) == len(local)
            for a, b in zip(got, local):
                for f in ("offset", "label", "index", "value"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f))


def _train_args(data_in, model_out):
    return ["task=train", f"data_in={data_in}", "V_dim=0", "l1=1", "l2=1",
            "lr=1", "batch_size=100", "max_num_epochs=3", "shuffle=0",
            "report_interval=0", "stop_rel_objv=0", "num_jobs_per_epoch=1",
            "num_producers=1", "producer_mode=thread",
            f"model_out={model_out}", "device=cpu"]


def test_train_and_pred_over_remote_uris(memfs, tmp_path):
    """A remote data_in and model_out give the local run's model bytes;
    JAX's store reads it; task=pred from the remote model into a remote
    pred_out writes the local run's pred bytes."""
    from difacto_tpu.store.local import SlotStore as JStore
    from difacto_tpu.updaters.sgd_updater import SGDUpdaterParam as JP
    _put("memory://in/rcv1.libsvm", RCV1)
    local = str(tmp_path / "m")
    assert main(_train_args(RCV1, local)) == 0
    assert main(_train_args("memory://in/rcv1.libsvm",
                            "memory://out/m")) == 0
    names = [p.rsplit("/", 1)[-1] for p in stream.listdir("memory://out")]
    assert "m_part-0" in names and "m_part-0.manifest.json" in names
    assert not any(n.endswith(".tmp") for n in names), names
    with open(local + "_part-0", "rb") as f:
        assert _entries(_get("memory://out/m_part-0")) == _entries(f.read())
    with open(local + "_part-0.manifest.json", "rb") as f:
        assert _get("memory://out/m_part-0.manifest.json") == f.read()
    js = JStore(JP(V_dim=0))
    assert js.load("memory://out/m_part-0") > 0

    pred = ["task=pred", "V_dim=0", "batch_size=100", "device=cpu"]
    assert main(pred + [f"data_in={RCV1}", f"model_in={local}_part-0",
                        f"pred_out={tmp_path / 'p'}"]) == 0
    assert main(pred + ["data_in=memory://in/rcv1.libsvm",
                        "model_in=memory://out/m_part-0",
                        "pred_out=memory://out/p"]) == 0
    with open(tmp_path / "p_part-0", "rb") as f:
        want = f.read()
    assert _get("memory://out/p_part-0") == want and want.count(b"\n") == 100


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    d = tmp_path_factory.mktemp("remote_criteo")
    (d / "train.txt").write_bytes(synthetic_criteo(300, 61))
    return str(d / "train.txt")


@pytest.mark.parametrize("encoding,localize", [("rec2", "1"), ("npz", "1"),
                                               ("rec2", "0")])
def test_convert_to_remote_writes_jax_members(memfs, criteo, encoding,
                                              localize):
    kw = [("data_in", criteo), ("data_format", "criteo"),
          ("data_out_format", "rec"), ("rec_encoding", encoding),
          ("rec_localize", localize), ("batch_size", "100"),
          ("convert_procs", "1")]
    for mod, d in ((tconv, "t"), (jconv, "j")):
        c = mod.Converter()
        c.init(kw + [("data_out", f"memory://{d}/c.rec")])
        c.run()
        assert c.num_rows == 300
    got = stream.listdir_files("memory://t/c.rec")
    want = stream.listdir_files("memory://j/c.rec")
    assert [(p.rsplit("/", 1)[-1], n) for p, n in got] \
        == [(p.rsplit("/", 1)[-1], n) for p, n in want]
    assert len(got) == 3
    for (p, _), (q, _) in zip(got, want):
        a, b = _get(p), _get(q)
        if encoding == "npz":
            assert _entries(a) == _entries(b)
        else:
            assert a == b
    # the remote cache reads back as the local one does
    blocks = list(Reader("memory://t/c.rec", "rec", 0, 1))
    assert sum(b.size for b in blocks) == 300


def test_train_from_a_remote_cache_equals_the_local_cache(memfs, criteo,
                                                          tmp_path):
    import torch

    from difacto_tpu_torch.learners.sgd import SGDLearner
    conv = [("data_in", criteo), ("data_format", "criteo"),
            ("data_out_format", "rec"), ("batch_size", "100"),
            ("convert_procs", "1")]
    for out in (str(tmp_path / "c.rec"), "memory://c/c.rec"):
        c = tconv.Converter()
        c.init(conv + [("data_out", out)])
        c.run()
    tables = []
    for data_in, model_out in ((str(tmp_path / "c.rec"), str(tmp_path / "m")),
                               ("memory://c/c.rec", "memory://c/m")):
        ln = SGDLearner(device="cpu")
        ln.init([("data_in", data_in), ("data_format", "rec"),
                 ("V_dim", "4"), ("hash_capacity", "4096"),
                 ("batch_size", "100"), ("max_num_epochs", "2"),
                 ("num_jobs_per_epoch", "1"), ("num_producers", "1"),
                 ("producer_mode", "thread"), ("report_interval", "0"),
                 ("stop_rel_objv", "0"), ("model_out", model_out)])
        ln.run()
        tables.append(ln.store.state.VVg.view(torch.int32).clone())
    assert torch.equal(tables[0], tables[1])
    with open(tmp_path / "m_part-0", "rb") as f:
        assert _entries(_get("memory://c/m_part-0")) == _entries(f.read())


def test_memory_convert_keeps_members_where_jax_workers_lose_them(
        memfs, criteo, monkeypatch):
    """The reference fault (ROADMAP.md, Queue 3): on 8 cores both
    packages' auto rule picks 8 convert workers; for a ``memory://``
    output JAX's workers write into their own processes' memory and the
    cache reads back empty, while the port converts in one process."""
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    kw = [("data_in", criteo), ("data_format", "criteo"),
          ("data_out_format", "rec"), ("batch_size", "100")]
    jc = jconv.Converter()
    jc.init(kw + [("data_out", "memory://j/c.rec")])
    assert jc.resolve_procs() == 8
    tc = tconv.Converter()
    tc.init(kw + [("data_out", "memory://t/c.rec")])
    assert tc.resolve_procs() == 1
    tc.run()
    assert sum(b.size for b in Reader("memory://t/c.rec", "rec", 0, 1)) \
        == 300
    # the JAX workers' loss: what each of its worker processes runs
    # (convert_part_iter on its byte range), run in another process
    import pickle
    import subprocess
    jc = jconv.Converter()
    jc.init(kw + [("data_out", "memory://j/c.rec")])
    p = jc.param
    spec = jconv._ConvertSpec(
        data_in=p.data_in, data_format=p.data_format,
        out_dir=jc._open_rec_part(0, False),
        member_suffix=jc.member_suffix(), member_rows=jc.member_rows(),
        rec_localize=p.rec_localize, rec_compress=p.rec_compress,
        chunk_bytes=32 << 20, n_parts=2)
    code = ("import pickle, sys\n"
            "from difacto_tpu.data.converter import convert_part_iter\n"
            "from difacto_tpu.utils import stream\n"
            "spec = pickle.loads(sys.stdin.buffer.read())\n"
            "rows = sum(it[1] for part in range(2)\n"
            "           for it in convert_part_iter(spec, part))\n"
            "print(rows, len(stream.listdir_files(spec.out_dir)))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       input=pickle.dumps(spec), capture_output=True,
                       env=dict(os.environ, PYTHONPATH=_ROOT,
                                JAX_PLATFORMS="cpu"), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [b"300", b"4"]   # written, in that process
    assert stream.listdir_files("memory://j/c.rec") == []
    with pytest.raises(FileNotFoundError, match="empty data uri"):
        list(JReader("memory://j/c.rec", "rec", 0, 1))
    # a local output keeps the auto rule
    tc = tconv.Converter()
    tc.init(kw + [("data_out", "/tmp/never_written.rec")])
    assert tc.resolve_procs() == 8
