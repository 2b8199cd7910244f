"""The port's native C++ parsers against its Python parsers and against the
JAX package's, byte for byte (tolerance 0: the same dtypes and bytes in
every array), on the rcv1 fixture, the edge cases and malformed input:
libsvm, criteo (train and test mode, CRLF), adfea and MurmurHash64A.

The port builds its own library into ``difacto_tpu_torch/_build/`` from
its own copy of the sources; nothing is written beside the package.
"""

import ctypes
import os

import numpy as np
import pytest

from difacto_tpu.data import parsers as jparsers
from difacto_tpu_torch import native
from difacto_tpu_torch.data import native_parsers as nat
from difacto_tpu_torch.data import parsers as tparsers
from difacto_tpu_torch.ops.build import BUILD_DIR

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("offset", "label", "index", "value", "weight")


@pytest.fixture(scope="module")
def lib():
    got = native.get_lib()
    assert got is not None, "g++ could not build the port's native parsers"
    return got


def assert_same_block(a, b, what):
    assert a.size == b.size, what
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (what, f)
            continue
        assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), (what, f)


def _criteo_chunk(nrows, seed, with_empties=True):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(nrows):
        ints = [str(rng.randint(0, 1000))
                if (not with_empties or rng.rand() > 0.2) else ""
                for _ in range(13)]
        cats = [f"c{rng.randint(0, 9999):x}"
                if (not with_empties or rng.rand() > 0.1) else ""
                for _ in range(26)]
        lines.append(f"{rng.randint(0, 2)}\t" + "\t".join(ints + cats))
    return ("\n".join(lines) + "\n").encode()


def _adfea_chunk(nrows, seed, sep=b" "):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(nrows):
        feats = " ".join(f"{rng.randint(0, 1 << 40)}:{rng.randint(0, 9000)}"
                         for _ in range(rng.randint(1, 12)))
        lines.append(f"{i} {rng.randint(1, 5)} {rng.randint(0, 2)} {feats}")
    return ("\n".join(lines) + "\n").encode().replace(b" ", sep)


LIBSVM_EDGES = [
    b"",
    b"\n\n\n",
    b"1\n0\n",                          # label-only rows
    b"1 5:1 7:1\n0 2:1\n",              # all-ones: the value array elided
    b"-1 3:0.5 9:2.25\r\n+1 1:1e-3\r\n",
    b"0.5 18446744073709551615:4\n",    # the largest uint64 id
    b"1 5 7:2\n0 3\n",                  # implicit and explicit values mixed
]


def test_library_builds_into_the_ignored_build_dir(lib):
    path = native.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert str(path).startswith(os.path.join(_ROOT, "difacto_tpu_torch",
                                             "_build"))
    # nothing beside the sources
    assert not [f for f in os.listdir(native.SRC_DIR) if f.endswith(".so")]


@pytest.mark.parametrize("case", ["fixture"] + list(range(len(LIBSVM_EDGES))))
def test_libsvm_native_python_and_jax_agree(lib, case):
    if case == "fixture":
        with open(os.path.join(_ROOT, "tests", "data",
                               "rcv1_100.libsvm"), "rb") as f:
            chunk = f.read()
    else:
        chunk = LIBSVM_EDGES[case]
    want = jparsers.parse_libsvm_ref(chunk)
    assert_same_block(nat.parse_libsvm_native(chunk), want, "native")
    assert_same_block(tparsers.parse_libsvm(chunk), want, "python")
    assert_same_block(tparsers.get_parser("libsvm")(chunk), want, "dispatch")


@pytest.mark.parametrize("chunk", [
    b"1 nocolon:\n", b"1 5:\n0 3:1\n", b"1 -5:2\n", b"1 5:\x0c\n0 3:1\n",
    b"1 18446744073709551616:1\n"])
def test_libsvm_malformed_raises_in_every_parser(lib, chunk):
    for parse in (nat.parse_libsvm_native, tparsers.parse_libsvm,
                  jparsers.parse_libsvm):
        with pytest.raises(ValueError):
            parse(chunk)


@pytest.mark.parametrize("is_train,seed", [(True, 0), (True, 7),
                                           (False, 1)])
def test_criteo_native_python_and_jax_agree(lib, is_train, seed):
    chunk = _criteo_chunk(300, seed)
    if not is_train:     # label-less rows: drop the first field
        chunk = b"\n".join(line.split(b"\t", 1)[1] for line in
                           chunk.splitlines()) + b"\n"
    want = jparsers.parse_criteo_ref(chunk, is_train)
    assert_same_block(nat.parse_criteo_native(chunk, is_train), want,
                      "native")
    assert_same_block(tparsers.parse_criteo(chunk, is_train), want, "python")
    fmt = "criteo" if is_train else "criteo_test"
    assert_same_block(tparsers.get_parser(fmt)(chunk), want, "dispatch")


@pytest.mark.parametrize("chunk", [
    b"1\ta\tb\r\n\r\n0\tc\r\n",                  # a blank CRLF line
    b"\r\n",
    b"",
    ("\t".join(["7"] * 40) + "\n").encode(),    # every field filled
    b"0\t\t\t\n1\t5\n"])                        # empty fields, short rows
def test_criteo_edges_agree(lib, chunk):
    for is_train in (True, False):
        want = jparsers.parse_criteo_ref(chunk, is_train)
        assert_same_block(nat.parse_criteo_native(chunk, is_train), want,
                          ("native", chunk, is_train))
        assert_same_block(tparsers.parse_criteo(chunk, is_train), want,
                          ("python", chunk, is_train))


@pytest.mark.parametrize("sep", [b" ", b"\t"])
def test_adfea_native_python_and_jax_agree(lib, sep):
    chunk = _adfea_chunk(200, 3, sep)
    flat = b" ".join(chunk.splitlines()[:50])   # one line, spaces only
    for c in (chunk, flat, b"", b"1 2 0\n", b"1 2 1 5:4097\r\n"):
        want = jparsers.parse_adfea(c)
        assert_same_block(nat.parse_adfea_native(c), want, ("native", c))
        assert_same_block(tparsers.parse_adfea(c), want, ("python", c))
        assert_same_block(tparsers.get_parser("adfea")(c), want,
                          ("dispatch", c))


@pytest.mark.parametrize("chunk", [b"1 2 0 x:3\n", b"1 2 0 5:y\n"])
def test_adfea_malformed_raises_in_every_parser(lib, chunk):
    for parse in (nat.parse_adfea_native, tparsers.parse_adfea,
                  jparsers.parse_adfea):
        with pytest.raises(ValueError):
            parse(chunk)


def test_murmur64a_native_matches_bulk_and_jax(lib):
    strings = [b"", b"a", b"ab", b"criteo", b"x" * 7, b"y" * 8, b"z" * 9,
               b"longer_categorical_value" * 3, bytes(range(256))]
    buf = np.frombuffer(b"".join(strings), dtype=np.uint8)
    lens = np.array([len(s) for s in strings], dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    bulk = tparsers._hash64_bulk(buf, starts, lens)
    for s, h in zip(strings, bulk.tolist()):
        want = jparsers._hash64(s)
        assert lib.difacto_murmur64a(s, len(s), 0) == want == h, s


def test_parsers_fall_back_to_python_without_the_library(monkeypatch):
    """No library (no g++): every format still parses, to the same
    bytes."""
    monkeypatch.setattr(nat, "get_lib", lambda: None)
    chunk = _criteo_chunk(50, 11)
    assert_same_block(nat.parse_criteo_native(chunk),
                      jparsers.parse_criteo_ref(chunk), "criteo")
    chunk = _adfea_chunk(50, 12)
    assert_same_block(nat.parse_adfea_native(chunk),
                      jparsers.parse_adfea(chunk), "adfea")
    chunk = LIBSVM_EDGES[4]
    assert_same_block(nat.parse_libsvm_native(chunk),
                      jparsers.parse_libsvm_ref(chunk), "libsvm")


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown data format"):
        tparsers.get_parser("csv")
