"""Text format parsers: libsvm, criteo and adfea (counterpart of
difacto_tpu/data/parsers.py).

libsvm and criteo in bulk numpy: one ``np.frombuffer`` over the chunk,
single-pass delimiter scans, exact uint64 digit accumulation for feature
ids, a correctly-rounded float path for labels and values, and a
lane-parallel MurmurHash64A for the criteo categorical hashing; adfea is
a token loop. They are the fallback of the native C++ parsers
(data/native_parsers.py), which :func:`get_parser` hands out, and all
give the same RowBlocks as the JAX package's parsers, so both packages
slot a row identically.

Implicit-value tokens (``idx`` with no ``:val``) parse as value 1.0; the
value array is elided (None) when every value is 1.0.
"""

from __future__ import annotations

import numpy as np

from ..base import FEAID_DTYPE, REAL_DTYPE
from .rowblock import RowBlock, empty_block

_U64_MAX = (1 << 64) - 1

# ------------------------------------------------------------ bulk lexing
def _token_matrix(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  pad: int):
    """Gather variable-length byte tokens into a right-padded [L, n]
    uint8 matrix + validity mask (L = longest token, COLUMN-major so the
    per-column loops downstream run over contiguous rows). L is ~20 for
    numbers, so the whole conversion is a handful of numpy passes."""
    L = int(lens.max()) if len(lens) else 0
    # int32 gather indices: half the footprint of the position matrix
    # (chunks are far below 2 GB)
    pos = (starts.astype(np.int32)[None, :]
           + np.arange(L, dtype=np.int32)[:, None])
    np.minimum(pos, np.int32(buf.size - 1), out=pos)
    ch = buf[pos]
    mask = np.arange(L, dtype=np.int32)[:, None] < \
        lens.astype(np.int32)[None, :]
    ch[~mask] = pad
    return ch, mask


def _parse_uint64_tokens(chunk: bytes, buf: np.ndarray, starts: np.ndarray,
                         lens: np.ndarray, what: str) -> np.ndarray:
    """Exact vectorized uint64 parse (digit accumulation — float64 would
    silently round ids past 2^53)."""
    n = len(starts)
    if n == 0:
        return np.zeros(0, FEAID_DTYPE)
    if (lens <= 0).any():
        raise ValueError(f"empty {what}")
    L = int(lens.max())
    if L > 20:
        raise ValueError(f"{what} overflows uint64")
    # RIGHT-aligned gather: digits occupy the trailing columns, leading
    # cells (bytes before the token) zero out in one mask pass — the
    # accumulation then runs unconditionally in place (a leading zero is
    # the identity), no per-column where/temporaries
    pos = ((starts + lens).astype(np.int64)[None, :] - L
           + np.arange(L, dtype=np.int64)[:, None])
    np.clip(pos, 0, buf.size - 1, out=pos)
    ch = buf[pos]
    valid = np.arange(L, dtype=np.int32)[:, None] >= \
        (L - lens.astype(np.int32))[None, :]
    # '0'..'9' minus 48 stays <= 9 in uint8; any other byte wraps past 9
    d = ch - np.uint8(48)
    if ((d > 9) & valid).any():
        raise ValueError(f"malformed {what} (non-digit)")
    d[~valid] = 0
    val = np.zeros(n, np.uint64)
    ten = np.uint64(10)
    for j in range(L):
        np.multiply(val, ten, out=val)
        np.add(val, d[j], out=val, casting="unsafe")
    if (lens == 20).any():
        # the only lengths where uint64 accumulation can wrap: check
        # those few tokens exactly
        for s, ln in zip(starts[lens == 20], lens[lens == 20]):
            if int(chunk[int(s):int(s) + int(ln)]) > _U64_MAX:
                raise ValueError(f"{what} overflows uint64")
    return val.astype(FEAID_DTYPE)


def _parse_float_tokens(chunk: bytes, buf: np.ndarray, starts: np.ndarray,
                        lens: np.ndarray) -> np.ndarray:
    """Vectorized float parse. The dominant token shape —
    ``[sign]digits[.digits]`` — takes a 5-op-per-column fast lane
    (:func:`_float_simple`); tokens carrying an exponent go through the
    general single-sweep parser (:func:`_float_general`); anything
    outside either (inf/nan, > 16 mantissa digits, |exponent| > 22,
    stray characters) falls back to Python ``float`` per token, which
    also supplies the ValueError for genuinely malformed input. Both
    vector lanes accumulate the mantissa exactly in float64 and apply
    the scale as ONE multiply or divide by an exact power of ten, so
    results are correctly rounded — identical to strtod."""
    n = len(starts)
    if n == 0:
        return np.empty(0, np.float64)
    # optimistic tiering: run the fast lane on everything, re-run only
    # its rejects through the general lane, and only ITS rejects through
    # Python float — typical data never leaves tier 1, so no masks or
    # pre-classification costs are paid at all
    out, bad = _float_simple(buf, starts, lens)
    if bad.any():
        idx = np.flatnonzero(bad)
        out[idx], gbad = _float_general(buf, starts[idx], lens[idx])
        for i in idx[gbad]:
            s, ln = int(starts[i]), int(lens[i])
            out[i] = float(chunk[s:s + ln])  # ValueError on real garbage
    return out


def _float_simple(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Fast lane: ``[sign]digits[.digits]`` -> (values, bad_mask). The
    dot column comes straight from the gathered byte matrix (the pad
    byte is '0', so pads can never fake a dot), and the accumulation
    runs in place with per-column ``where=`` masks — no temporaries."""
    n = len(starts)
    cap = max(buf.size - 1, 0)
    c0 = buf[np.minimum(starts, cap)]
    neg = c0 == 45
    signed = neg | (c0 == 43)
    s = starts + signed
    ln = lens - signed
    bad = ln <= 0
    ch, mask = _token_matrix(buf, s, np.maximum(ln, 0), ord("0"))
    dotm = ch == 46
    ndot = dotm.sum(axis=0, dtype=np.int16)
    has_dot = ndot == 1
    bad |= ndot > 1
    dcol = np.where(has_dot, dotm.argmax(axis=0), ln)
    d = ch - np.uint8(48)
    use = mask & ~dotm
    bad |= ((d > 9) & use).any(axis=0)
    # uint64 digit accumulation is EXACT up to 19 digits (vs 15 for
    # float64 — ML dumps routinely carry 17-digit fractions); the one
    # uint64->float64 conversion plus one divide by an exact power of
    # ten stays within 1 ulp of strtod, invisible after the float32 cast
    val = np.zeros(n, np.uint64)
    ten = np.uint64(10)
    for j in range(ch.shape[0]):
        np.multiply(val, ten, out=val, where=use[j])
        np.add(val, d[j], out=val, casting="unsafe", where=use[j])
    ndigits = ln - has_dot
    frac = np.where(has_dot, ln - dcol - 1, 0)
    bad |= (ndigits <= 0) | (ndigits > 19) | (frac > 22)
    out = val.astype(np.float64) / np.power(10.0, np.minimum(frac, 22))
    return np.where(neg, -out, out), bad


def _float_general(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """General lane: ``[sign]digits[.digits][e[sign]digits]`` ->
    (values, bad_mask)."""
    n = len(starts)
    ch, mask = _token_matrix(buf, starts, lens, 32)
    L = ch.shape[0]
    neg = ch[0] == 45

    # ONE left-to-right column sweep over the [L, n] matrix (contiguous
    # rows): digits before the first 'e' accumulate into the mantissa,
    # digits after into the exponent; '.' starts the fraction count.
    # State lives in small per-token vectors — no [n, L] numeric
    # temporaries (those measured slower than the loop reference).
    bad = lens <= 0
    mant = np.zeros(n, np.uint64)
    ev = np.zeros(n)
    n_mant = np.zeros(n, np.int16)
    n_frac = np.zeros(n, np.int16)
    n_exp = np.zeros(n, np.int16)
    seen_e = np.zeros(n, dtype=bool)
    seen_dot = np.zeros(n, dtype=bool)
    prev_e = np.zeros(n, dtype=bool)
    eneg = np.zeros(n, dtype=bool)
    for j in range(L):
        cj = ch[j]
        mj = mask[j]
        dj = (cj >= 48) & (cj <= 57)
        ej = ((cj == 101) | (cj == 69)) & mj
        dotj = (cj == 46) & mj
        signj = ((cj == 43) | (cj == 45)) & mj
        bad |= mj & ~(dj | ej | dotj | signj)
        if j:
            # signs only lead the mantissa (col 0) or the exponent
            bad |= signj & ~prev_e
            eneg |= prev_e & (cj == 45)
        bad |= (ej & seen_e) | (dotj & (seen_dot | seen_e))
        in_mant = dj & ~seen_e
        in_exp = dj & seen_e
        dvalj = (cj - np.uint8(48)).astype(np.uint64)
        mant = np.where(in_mant, mant * np.uint64(10) + dvalj, mant)
        ev = np.where(in_exp, ev * 10.0 + (cj.astype(np.float64) - 48.0),
                      ev)
        n_mant += in_mant
        n_frac += in_mant & seen_dot
        n_exp += in_exp
        seen_e |= ej
        seen_dot |= dotj
        prev_e = ej
    bad |= (n_mant == 0) | (n_mant > 19)  # 19 digits: exact in uint64
    bad |= seen_e & (n_exp == 0)

    exp10 = np.where(eneg, -ev, ev) - n_frac
    # one multiply OR divide by an exact power of ten after the single
    # uint64->float64 conversion: within 1 ulp of strtod for
    # |exp10| <= 22, invisible after the float32 cast
    bad |= np.abs(exp10) > 22
    mantf = mant.astype(np.float64)
    p_pos = np.power(10.0, np.clip(exp10, 0, 22))
    p_neg = np.power(10.0, np.clip(-exp10, 0, 22))
    res = np.where(exp10 >= 0, mantf * p_pos, mantf / p_neg)
    return np.where(neg, -res, res), bad


# non-whitespace lookup table (bytes.split semantics: space \t \n \r \v \f)
_NON_WS_LUT = np.ones(256, dtype=np.int8)
_NON_WS_LUT[[9, 10, 11, 12, 13, 32]] = 0


# ---------------------------------------------------------------- libsvm
def parse_libsvm(chunk: bytes) -> RowBlock:
    """Bulk-numpy parse of libsvm text: ``label idx[:val] idx[:val] ...``
    per line. One pass finds token boundaries and line ids; ids and
    values convert vectorized (see module docstring). Tokens without
    ``:val`` are implicit value 1.0; an all-ones chunk elides the value
    array (binary features)."""
    buf = np.frombuffer(chunk, dtype=np.uint8)
    if buf.size == 0:
        return empty_block()
    tok = _NON_WS_LUT[buf]  # one gather instead of 4 comparison passes
    d = np.diff(tok, prepend=np.int8(0), append=np.int8(0))
    starts = np.flatnonzero(d == 1).astype(np.int64)
    if starts.size == 0:
        return empty_block()
    ends = np.flatnonzero(d == -1).astype(np.int64)

    # line id per token = newlines before its start (positions, not a
    # whole-buffer cumsum: tokens are ~10x sparser than bytes)
    nl_pos = np.flatnonzero(buf == 10).astype(np.int64)
    line_of = np.searchsorted(nl_pos, starts)
    first = np.empty(len(starts), dtype=bool)
    first[0] = True
    np.not_equal(line_of[1:], line_of[:-1], out=first[1:])

    lab_s, lab_e = starts[first], ends[first]
    feat_s, feat_e = starts[~first], ends[~first]
    label = _parse_float_tokens(chunk, buf, lab_s,
                                lab_e - lab_s).astype(REAL_DTYPE)

    # split each feature token at its (single) ':' — one searchsorted
    # finds each token's first colon at-or-after its start; the NEXT
    # colon position rules out a second one inside the same token
    colon_pos = np.flatnonzero(buf == 58).astype(np.int64)
    if colon_pos.size:
        nth = np.searchsorted(colon_pos, feat_s)
        cand = colon_pos[np.minimum(nth, colon_pos.size - 1)]
        has_v = (nth < colon_pos.size) & (cand < feat_e)
        nxt = colon_pos[np.minimum(nth + 1, colon_pos.size - 1)]
        if (has_v & (nth + 1 < colon_pos.size) & (nxt < feat_e)).any():
            raise ValueError("malformed libsvm token (multiple ':')")
        cpos = np.where(has_v, cand, feat_e)
    else:
        has_v = np.zeros(len(feat_s), dtype=bool)
        cpos = feat_e
    index = _parse_uint64_tokens(chunk, buf, feat_s, cpos - feat_s,
                                 "libsvm feature id")
    value64 = np.ones(len(feat_s), np.float64)
    if has_v.any():
        vs = cpos[has_v] + 1
        vl = feat_e[has_v] - vs
        if (vl <= 0).any():
            raise ValueError("empty libsvm value after ':'")
        value64[has_v] = _parse_float_tokens(chunk, buf, vs, vl)

    # row id per feature token = labels seen so far (cumsum beats a
    # searchsorted over the token array)
    row_of = np.cumsum(first)[~first] - 1
    counts = np.bincount(row_of, minlength=len(lab_s))
    offset = np.zeros(len(lab_s) + 1, dtype=np.int64)
    np.cumsum(counts, out=offset[1:])
    value = value64.astype(REAL_DTYPE)
    return RowBlock(
        offset=offset, label=label, index=index,
        value=None if (value == 1.0).all() else value)


_M64 = 0xC6A4A7935BD1E995


def _hash64_bulk(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 seed: int = 0) -> np.ndarray:
    """Lane-parallel MurmurHash64A over variable-length byte spans of
    ``buf``, bit-identical per span to the scalar MurmurHash64A. The loops
    run over the LONGEST span's 8-byte blocks (criteo fields are short),
    each iteration a masked vector op over every span at once; uint64
    numpy arithmetic wraps mod 2^64 exactly like the scalar masks."""
    n = len(starts)
    M = np.uint64(_M64)
    h = np.uint64(seed) ^ (lens.astype(np.uint64) * M)
    if n == 0:
        return h
    cap = max(buf.size - 1, 0)

    def byte_at(pos):  # gather n bytes, then widen (never the whole buf)
        return buf[np.minimum(pos, cap)].astype(np.uint64)

    nblocks = lens // 8
    for i in range(int(nblocks.max())):
        base = starts + 8 * i
        k = np.zeros(n, np.uint64)
        for j in range(8):
            k |= byte_at(base + j) << np.uint64(8 * j)
        k *= M
        k ^= k >> np.uint64(47)
        k *= M
        h = np.where(i < nblocks, (h ^ k) * M, h)
    tail_len = lens - nblocks * 8
    tbase = starts + nblocks * 8
    tv = np.zeros(n, np.uint64)
    for j in range(7):
        byte = np.where(j < tail_len, byte_at(tbase + j), np.uint64(0))
        tv |= byte << np.uint64(8 * j)
    h = np.where(tail_len > 0, (h ^ tv) * M, h)
    h ^= h >> np.uint64(47)
    h *= M
    h ^= h >> np.uint64(47)
    return h


# ---------------------------------------------------------------- criteo
def parse_criteo(chunk: bytes, is_train: bool = True) -> RowBlock:
    """Bulk-numpy parse of Criteo CTR tab-separated format.

    ``<label> <int f1..f13> <cat f1..f26>``; each non-empty field is
    hashed to 64 bits (lane-parallel MurmurHash64A) with its column id
    packed in the low 12 bits (criteo_parser.h:57-86). Field boundaries
    come from one tab/newline scan; no per-line Python."""
    buf = np.frombuffer(chunk, dtype=np.uint8)
    if buf.size == 0:
        return empty_block()
    nl = np.flatnonzero(buf == 10).astype(np.int64)
    ls = np.concatenate(([0], nl + 1))
    le = np.concatenate((nl, [buf.size]))
    # strip '\r' at both line ends (the loop reference strips b"\r");
    # a few vector passes cover real data, stragglers finish per line
    for _ in range(4):
        m = (le > ls) & (buf[np.maximum(le - 1, 0)] == 13)
        if not m.any():
            break
        le = le - m
    for _ in range(4):
        m = (le > ls) & (buf[np.minimum(ls, buf.size - 1)] == 13)
        if not m.any():
            break
        ls = ls + m
    dirty = (le > ls) & ((buf[np.maximum(le - 1, 0)] == 13)
                         | (buf[np.minimum(ls, buf.size - 1)] == 13))
    for i in np.flatnonzero(dirty):  # pragma: no cover - exotic input
        while le[i] > ls[i] and buf[le[i] - 1] == 13:
            le[i] -= 1
        while le[i] > ls[i] and buf[ls[i]] == 13:
            ls[i] += 1
    keep = le > ls
    ls, le = ls[keep], le[keep]
    nlines = len(ls)
    if nlines == 0:
        return empty_block()

    tabs = np.flatnonzero(buf == 9).astype(np.int64)
    tl = np.searchsorted(ls, tabs, side="right") - 1
    ok_tab = (tl >= 0)
    safe_tl = np.maximum(tl, 0)
    ok_tab &= (tabs >= ls[safe_tl]) & (tabs < le[safe_tl])
    tabs, tl = tabs[ok_tab], tl[ok_tab]

    nfields = np.bincount(tl, minlength=nlines) + 1
    total = int(nfields.sum())
    firsts_idx = np.concatenate(([0], np.cumsum(nfields)[:-1]))
    first_field = np.zeros(total, dtype=bool)
    first_field[firsts_idx] = True
    last_field = np.zeros(total, dtype=bool)
    last_field[firsts_idx + nfields - 1] = True
    f_start = np.empty(total, np.int64)
    f_end = np.empty(total, np.int64)
    f_start[first_field] = ls
    f_start[~first_field] = tabs + 1
    f_end[last_field] = le
    f_end[~last_field] = tabs
    f_line = np.repeat(np.arange(nlines), nfields)
    col = np.arange(total) - np.repeat(firsts_idx, nfields)

    pos0 = 1 if is_train else 0
    if is_train:
        labels = _parse_float_tokens(
            chunk, buf, f_start[first_field],
            f_end[first_field] - f_start[first_field]).astype(REAL_DTYPE)
    else:
        labels = np.zeros(nlines, dtype=REAL_DTYPE)

    featm = (col >= pos0) & (col < pos0 + 39) & (f_end > f_start)
    fs, flen = f_start[featm], f_end[featm] - f_start[featm]
    h = _hash64_bulk(buf, fs, flen)
    grp = (col[featm] - pos0).astype(np.uint64)
    ids = ((h << np.uint64(12)) | grp).astype(FEAID_DTYPE)

    counts = np.bincount(f_line[featm], minlength=nlines)
    offset = np.zeros(nlines + 1, dtype=np.int64)
    np.cumsum(counts, out=offset[1:])
    return RowBlock(
        offset=offset,
        label=labels,
        index=ids,
        value=None,  # binary features
    )


def parse_adfea(chunk: bytes) -> RowBlock:
    """Parse adfea: ``lineid count label idx:gid idx:gid ...``, a
    whitespace token stream. Tokens without ``:`` cycle through (lineid,
    count, label), the third starting a row labelled 1 iff it begins with
    ``1``; an ``idx:gid`` token is a feature ``idx << 12 | gid % 4096``
    of the current row (adfea_parser.h:54-77)."""
    labels = []
    counts = []
    ids: list = []
    i = 0
    cur = -1
    for tok in chunk.split():
        head, sep, tail = tok.partition(b":")
        if sep:
            idx = int(head)
            if not 0 <= idx <= _U64_MAX:
                raise OverflowError(f"adfea feature id {idx} is not a "
                                    "uint64")
            ids.append((idx << 12 | int(tail) % 4096) & _U64_MAX)
            if cur >= 0:
                counts[cur] += 1
        elif i == 2:
            i = 0
            labels.append(1.0 if head.startswith(b"1") else 0.0)
            counts.append(0)
            cur += 1
        else:
            i += 1
    if not labels:
        return empty_block()
    offset = np.zeros(len(labels) + 1, dtype=np.int64)
    np.cumsum(counts, out=offset[1:])
    return RowBlock(
        offset=offset,
        label=np.array(labels, dtype=REAL_DTYPE),
        index=np.array(ids, dtype=FEAID_DTYPE),
        value=None,
    )


def get_parser(fmt: str):
    """The chunk parser of a text format: the native C++ parsers
    (data/native_parsers.py), which fall back to the Python ones above
    when the library cannot be built."""
    from . import native_parsers as nat
    fmt = fmt.lower()
    if fmt == "libsvm":
        return nat.parse_libsvm_native
    if fmt == "criteo":
        return nat.parse_criteo_native
    if fmt == "criteo_test":
        return lambda chunk: nat.parse_criteo_native(chunk, is_train=False)
    if fmt == "adfea":
        return nat.parse_adfea_native
    raise ValueError(f"unknown data format: {fmt} (the port parses libsvm, "
                     "criteo, criteo_test, adfea and the rec cache)")
