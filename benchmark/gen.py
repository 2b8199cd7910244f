"""The general traffic generator: synthetic rows in the Criteo Display
Advertising Challenge layout (a label, integer fields, categorical
fields), drawn from a traffic file's parameters and a seed, and their
Criteo text.

The shape of ``chip_smoke.synthetic_criteo``, vectorised and drawn per
field: each categorical field's values follow a discrete power law
(``floor(u ** (-1 / (a - 1)))``, whose tail is the tail of zipf(a))
truncated to that field's own number of distinct values, as the traffic
file lists them; the integer fields follow a power law truncated to
``int_cap``; each field is empty with the traffic file's share for it;
the labels are Bernoulli draws from a planted logistic model of two
fields, so the objective falls. Each categorical field's values are
offset into a range of their own and written as 8 hex digits, the
integer fields as decimals. The same seed gives the same rows on every
machine (numpy's PCG64 stream, no device draws).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# each categorical field's values live in a range of their own
CAT_FIELD_SPAN = 1 << 26
_INT_DIGITS = 7          # the widest decimal an integer field can take


def power_law(rng: np.random.Generator, shape, a: float, cap
              ) -> np.ndarray:
    """Values in [1, cap] with P(X >= x) proportional to
    x ** -(a - 1) - (cap + 1) ** -(a - 1): the power law truncated to
    ``cap`` (a number, or one per column of ``shape``)."""
    cap = np.asarray(cap, dtype=np.float64)
    low = (cap + 1.0) ** -(a - 1.0)
    u = low + (1.0 - low) * (1.0 - rng.random(shape))     # (low, 1]
    x = np.floor(u ** (-1.0 / (a - 1.0)))
    return np.minimum(x, cap).astype(np.int64)


def make_rows(traffic: dict, n: int, seed: int) -> Dict[str, np.ndarray]:
    """``n`` rows of the traffic's mix: ``ints`` int64 [n, n_int] (>= 0),
    ``cats`` int64 [n, n_cat] (field offsets included), ``empty`` bool
    [n, n_int + n_cat] and ``labels`` int8 [n] (0 or 1)."""
    ni, nc = int(traffic["int_fields"]), int(traffic["cat_fields"])
    card = np.asarray(traffic["cat_cardinality"], dtype=np.int64)
    share = np.asarray(traffic["empty_share"], dtype=np.float64)
    if card.shape != (nc,) or share.shape != (ni + nc,):
        raise ValueError("one cardinality a categorical field and one "
                         "empty share a field")
    if int(card.max()) >= CAT_FIELD_SPAN:
        raise ValueError("a field's cardinality passes its value range")
    rng = np.random.default_rng(int(seed))
    ints = power_law(rng, (n, ni), traffic["int_zipf"],
                     int(traffic["int_cap"])) - 1
    cats = power_law(rng, (n, nc), traffic["cat_zipf"], card)
    cats += np.arange(nc, dtype=np.int64) * CAT_FIELD_SPAN
    empty = rng.random((n, ni + nc)) < share
    lab = traffic["label"]
    score = (lab["cat_weight"] * (cats[:, lab["cat_field"]]
                                  % lab["cat_mod"] == 0)
             + lab["int_weight"] * (ints[:, lab["int_field"]]
                                    % lab["int_mod"] == 0)
             + lab["bias"])
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-score))).astype(np.int8)
    if int(ints.max(initial=0)) >= 10 ** _INT_DIGITS:
        raise ValueError("int_cap too large for the text layout")
    return {"ints": ints, "cats": cats, "empty": empty, "labels": labels}


def _decimal_table(cap: int):
    """Every value below ``cap`` as a tab and 7 right-aligned decimal
    digits ([cap, 8] uint8), and which of those bytes the text keeps."""
    v = np.arange(cap, dtype=np.int64)
    chars = np.empty((cap, 1 + _INT_DIGITS), np.uint8)
    keep = np.ones((cap, 1 + _INT_DIGITS), bool)
    chars[:, 0] = 9
    for j in range(_INT_DIGITS):
        scale = 10 ** (_INT_DIGITS - 1 - j)
        chars[:, 1 + j] = 48 + (v // scale) % 10
        # digits from the leading one on, and always the last ("0")
        if j < _INT_DIGITS - 1:
            keep[:, 1 + j] = v >= scale
    return chars, keep


def _hex8(x: np.ndarray) -> np.ndarray:
    """32-bit values -> their 8 lower-case hex digits, [..., 8] uint8,
    most significant first, from a table of every 16-bit half."""
    v = np.arange(1 << 16, dtype=np.int64)
    half = np.frombuffer(b"0123456789abcdef", np.uint8)[
        (v[:, None] >> np.array([12, 8, 4, 0])) & 15]
    x = x.astype(np.int64)
    out = np.empty(x.shape + (8,), np.uint8)
    out[..., :4] = half[(x >> 16) & 0xFFFF]
    out[..., 4:] = half[x & 0xFFFF]
    return out


def criteo_text(rows: Dict[str, np.ndarray]) -> bytes:
    """The rows as Criteo text: ``label \\t int... \\t cat...`` lines,
    integers as decimals, categoricals as 8 hex digits, empty fields as
    nothing between their tabs. Built as one fixed-width byte matrix
    whose unused cells are masked out."""
    ints, cats, empty = rows["ints"], rows["cats"], rows["empty"]
    n, ni = ints.shape
    nc = cats.shape[1]
    chars, kchars = _decimal_table(int(ints.max(initial=0)) + 1)
    int_part = chars[ints].reshape(n, -1)
    int_keep = kchars[ints]
    int_keep[:, :, 1:] &= ~empty[:, :ni, None]
    cat_part = np.empty((n, nc, 9), np.uint8)
    cat_part[:, :, 0] = 9
    cat_part[:, :, 1:] = _hex8(cats)
    cat_keep = np.ones((n, nc, 9), bool)
    cat_keep[:, :, 1:] = ~empty[:, ni:, None]
    col = np.ones((n, 1), bool)
    mat = np.concatenate([48 + rows["labels"].astype(np.uint8)[:, None],
                          int_part, cat_part.reshape(n, -1),
                          np.full((n, 1), 10, np.uint8)], axis=1)
    keep = np.concatenate([col, int_keep.reshape(n, -1),
                           cat_keep.reshape(n, -1), col], axis=1)
    return mat[keep].tobytes()


def token_count(rows: Dict[str, np.ndarray]) -> int:
    """Non-empty fields over all rows: the tokens an epoch trains."""
    return int((~rows["empty"]).sum())
