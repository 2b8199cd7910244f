"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
where no GPU is visible, deciding at run time): the gather, and the
scatter with its FTRL/AdaGrad epilogue on and off, byte for byte against
their plain versions on the same card; the deterministic lane sum; the
chunked-run layout (equal to the CPU's) and the chunked backward (which
repeats bit for bit); and small training runs that repeat bit for bit,
one through the dictionary store's growth and the replay cache that also
equals its run on the plain versions; the device dedup of raw tokens
(equal to the CPU's), and streamed runs where ``device_dedup`` and the
process producers leave the host-dedup, thread-producer table bit for
bit; the cold tier's promotes and demotes (the two kernels at the tier's
padded sizes) leaving the CPU's table and residency bit for bit, a tiered
run that repeats and equals its run on the plain versions, and the WAL's
row round trip and a WAL-on run equal to the WAL-off one; a hot reload
on the card while the server scores (no batch torn across models, the
old table's memory returned) and a blue/green swap; a router over two
replicas on the card (the pred column, one gather per dispatch) and a
rolling restart on the card that returns the incumbents' memory.

On a machine with a GPU and without jax, run these without the suite's
conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import functools
import os
import time

import numpy as np
import pytest
import torch

from difacto_tpu_torch.ops import fused
from difacto_tpu_torch.updaters import sgd_updater as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    return torch.device("cuda")


def _slots(C, real, u, dev):
    s = torch.arange(C, C + u, dtype=torch.int32)
    s[:len(real)] = torch.tensor(sorted(real), dtype=torch.int32)
    return s.to(dev)


@pytest.mark.parametrize("bits,dt", [(torch.int32, torch.float32),
                                     (torch.int16, torch.bfloat16),
                                     (torch.int8, torch.int8)])
@pytest.mark.parametrize("row_bytes", [16, 48, 128, 256, 512, 1024, 1040])
def test_kernel_matches_plain_bytes(cuda, bits, dt, row_bytes):
    """Rows of 1, 3, 8, 16, 32, 64 and 65 vectors: sorted slots with OOB
    pads, then chip_smoke's edge cases (slot counts at the kernel's tiles
    and at its resident warps' edges, read from the library, with OOB
    lanes on both sides; an all-OOB vector; ``out=`` as a slice at an
    offset inside a larger output whose other rows stay as they were);
    byte for byte, one launch each."""
    from chip_smoke import gather_edge_cases
    g = torch.Generator(device=cuda).manual_seed(0)
    info = torch.iinfo(bits)
    C = 4096
    W = row_bytes // torch.tensor([], dtype=dt).element_size()
    table = torch.randint(info.min, info.max, (C, W), dtype=bits,
                          generator=g, device=cuda).view(dt)
    for real, u in (([0, 3, 77, 4095], 8), ([], 12), (range(0, C, 3), 1536)):
        slots = _slots(C, list(real), u, cuda)
        before = fused.gather_rows_cuda.launches
        got = fused.gather_rows(table, slots)
        torch.cuda.synchronize()
        assert fused.gather_rows_cuda.launches == before + 1
        want = fused.gather_rows_ref(table, slots)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), u

    def gather(t, s, out=None):
        before = fused.gather_rows_cuda.launches
        got = fused.gather_rows(t, s, out)
        assert fused.gather_rows_cuda.launches == before + 1
        return got

    assert gather_edge_cases(gather, dt, bits, g, cuda, C, (row_bytes,)) > 10


def test_kernel_refuses_what_it_cannot_take(cuda):
    table = torch.zeros((64, 128), device=cuda)
    slots = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fused.gather_rows(table, slots.long())
    with pytest.raises(ValueError, match="contiguous"):
        fused.gather_rows(table[:, ::2], slots)
    with pytest.raises(ValueError, match="16"):
        fused.gather_rows(torch.zeros((64, 3), device=cuda), slots)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.gather_rows(table, slots.cpu())


_LAYOUTS = {"in_pad": dict(V_dim=16),
            "appended_gap": dict(V_dim=16, pad_v_rows=False),
            "appended_v64": dict(V_dim=64, pad_v_rows=False),
            "appended_v8": dict(V_dim=8, pad_v_rows=False),
            "appended_v40": dict(V_dim=40, pad_v_rows=False),
            "in_pad_v40": dict(V_dim=40)}
_HYPER = dict(l1=0.5, l2=0.1, lr=0.05, V_l2=0.01, V_lr=0.02,
              V_threshold=2)
_C = 65536


def _fused_rows(param, n, seed, dev, C=4096):
    """[n, Wx] fused rows built on the card from seeded values, and the
    step inputs gw, gV, vmask (vmask 0 and 1, z around l1, cnt around
    V_threshold, some all-zero V halves)."""
    k = param.V_dim
    rng = np.random.RandomState(seed)
    V = (rng.randn(n, k) * 0.1).astype(np.float32)
    V[::7] = 0.0
    cols = [V, np.abs(rng.randn(n, k)).astype(np.float32),
            (rng.randn(n) * 0.5).astype(np.float32),
            (rng.randn(n) * 0.6).astype(np.float32),
            np.abs(rng.randn(n)).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32), rng.rand(n) < 0.5]
    rows = T.build_rows(param, C, *(torch.from_numpy(c).to(dev)
                                    for c in cols))
    gw = torch.from_numpy((rng.randn(n) * 0.3).astype(np.float32)).to(dev)
    gV = torch.from_numpy((rng.randn(n, k) * 0.1).astype(np.float32)).to(dev)
    vm = torch.from_numpy((rng.rand(n) < 0.6).astype(np.float32)).to(dev)
    return rows, gw, gV, vm


def _make_nonfinite(param, C, rows, gV):
    """NaN and +-Inf where the requant amax and the AdaGrad columns see
    them: in gV on every 5th row, and in the stored halves (the scale
    words of 8-bit rows, NaN fp8 codes, the V and Vg lanes of fp32 and
    bf16 rows) on others."""
    k, h, _, off = T.row_layout(param, C)
    nan, inf = float("nan"), float("inf")
    gV[4::5, 0] = inf
    gV[4::5, min(1, k - 1)] = -inf
    gV[4::5, k - 1] = nan
    if T.quantized(param):
        scal = rows[:, off:].view(torch.float32)
        scal[1::5, 5] = nan
        scal[2::5, 5] = inf
        scal[3::5, 6] = -inf
        if param.slot_dtype == "fp8":
            rows[::7, 0] = 0x7F          # NaN codes
            rows[3::7, h] = -1           # 0xFF, -NaN
    else:
        rows[1::5, 0] = nan
        rows[2::5, 0] = inf
        rows[3::5, h] = -inf
        rows[3::5, k - 1] = 3e38


def _scatter_cases(C):
    """(real slots, u): the tile edges of the kernel's persistent grid —
    a real/pad boundary inside a tile, u not a multiple of the tile, u
    larger than one pass of the grid, a single real row before pads, and
    an all-OOB vector."""
    rng = np.random.RandomState(3)

    def sample(n):
        return rng.choice(C, n, replace=False).tolist()
    return [([0, 3, 77, 4095], 8), ([], 12), (range(0, 4096, 3), 1536),
            ([77], 8), ([C - 1], 1536), (sample(11692), 12288),
            (sample(11692), 12301), (sample(40000), 49152), ([], 49152)]


@pytest.mark.parametrize("values", ["finite", "nonfinite"])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("epilogue", [True, False])
def test_scatter_kernel_matches_plain_bytes(cuda, kind, layout, epilogue,
                                            values):
    param = T.SGDUpdaterParam(slot_dtype=kind, hash_capacity=_C,
                              **_LAYOUTS[layout], **_HYPER)
    table, _, _, _ = _fused_rows(param, _C, 1, cuda, _C)
    epi = T.epilogue_spec(param, _C)
    plain = functools.partial(T.row_epilogue, param, _C)
    for real, u in _scatter_cases(_C):
        slots = _slots(_C, list(real), u, cuda)
        rows, gw, gV, vm = _fused_rows(param, u, 2, cuda, _C)
        if values == "nonfinite":
            _make_nonfinite(param, _C, rows, gV)
        got, want = table.clone(), table.clone()
        if epilogue:
            before = fused.fm_update_rows_cuda.launches
            fused.fm_update_rows(got, slots, rows, gw, gV, vm, epi, plain)
            fused.fm_update_rows_ref(want, slots, rows, gw, gV, vm, plain)
            assert fused.fm_update_rows_cuda.launches == before + 1
        else:
            before = fused.scatter_rows_cuda.launches
            fused.scatter_rows(got, slots, rows)
            fused.scatter_rows_ref(want, slots, rows)
            assert fused.scatter_rows_cuda.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), \
            f"u={u} real={len(real)}"
        if not real:
            assert torch.equal(got.view(torch.uint8),
                               table.view(torch.uint8))


def test_scatter_kernel_refuses_what_it_cannot_take(cuda):
    param = T.SGDUpdaterParam(V_dim=16, hash_capacity=64)
    epi = (T.epilogue_spec(param, 64),
           functools.partial(T.row_epilogue, param, 64))
    table = torch.zeros((64, 128), device=cuda)
    rows = torch.zeros((8, 128), device=cuda)
    slots = torch.arange(8, dtype=torch.int32, device=cuda)
    gw, vm = torch.zeros(8, device=cuda), torch.ones(8, device=cuda)
    gV = torch.zeros((8, 16), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fused.scatter_rows(table, slots.long(), rows)
    with pytest.raises(TypeError, match="rows are"):
        fused.scatter_rows(table, slots, rows.to(torch.bfloat16))
    with pytest.raises(TypeError, match="gV"):
        fused.fm_update_rows(table, slots, rows, gw, gV.double(), vm, *epi)
    with pytest.raises(ValueError, match="contiguous"):
        fused.scatter_rows(table, slots,
                           torch.zeros((128, 8), device=cuda).t())
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.fm_update_rows(table, slots.cpu(), rows, gw, gV, vm, *epi)
    with pytest.raises(ValueError, match="layout"):
        fused.fm_update_rows(torch.zeros((64, 256), device=cuda), slots,
                             torch.zeros((8, 256), device=cuda), gw, gV, vm,
                             *epi)


def test_lane_sum_on_the_card_is_sequential_and_repeats(cuda):
    """The card's lane sums equal the CPU's bit for bit (both add each
    lane's entries in ascending order) and repeat run to run."""
    from difacto_tpu_torch.ops.segment import lane_sum
    rng = np.random.RandomState(0)
    lanes = torch.from_numpy((rng.zipf(1.3, 40000) % 12288).astype(np.int32))
    data = torch.from_numpy(rng.randn(40000, 18).astype(np.float32))
    cpu = lane_sum(data, lanes, 12288)
    a = lane_sum(data.to(cuda), lanes.to(cuda), 12288)
    b = lane_sum(data.to(cuda), lanes.to(cuda), 12288)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.cpu().view(torch.int32), cpu.view(torch.int32))


def test_training_on_the_card_repeats_bit_for_bit(cuda, tmp_path):
    from difacto_tpu_torch.learners.sgd import SGDLearner
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "rcv1_100.libsvm")
    tables = []
    for run in range(2):
        ln = SGDLearner(device="cuda")
        ln.init([("data_in", data), ("V_dim", "4"), ("hash_capacity", "4096"),
                 ("max_num_epochs", "2"), ("l1", "0.1"),
                 ("V_threshold", "1")])
        ln.run()
        tables.append(ln.store.state.VVg.clone())
    assert torch.equal(tables[0].view(torch.int32),
                       tables[1].view(torch.int32))


@pytest.mark.parametrize("binary", [True, False])
def test_chunk_layout_on_the_card_equals_the_cpu(cuda, binary):
    """The chunked-run layout built on the card (sort, scans, scatters)
    equals the CPU's bit for bit, at the main path's panel shape."""
    from difacto_tpu_torch.ops.batch import panel_chunk_tokens_flat
    rng = np.random.RandomState(1)
    B, F, u_cap = 1024, 39, 12288
    idx = torch.from_numpy((rng.zipf(1.2, B * F) % 11000).astype(np.int32))
    vals = None if binary else torch.from_numpy(
        rng.rand(B * F).astype(np.float32))
    cpu = panel_chunk_tokens_flat(idx, vals, u_cap, B, F)
    card = panel_chunk_tokens_flat(idx.to(cuda), None if vals is None
                                   else vals.to(cuda), u_cap, B, F)
    for a, b in zip(cpu, card):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("k", [0, 16])
def test_chunked_backward_on_the_card_repeats(cuda, k):
    from difacto_tpu_torch.losses import FMParams
    from difacto_tpu_torch.losses import fm
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.ops.batch import PanelBatch, panel_chunk_tokens
    rng = np.random.RandomState(2)
    B, F, U = 1024, 39, 12288
    t = functools.partial(torch.tensor, device=cuda)
    pb = PanelBatch(
        idx=t((rng.zipf(1.2, (B, F)) % 11000).astype(np.int32)),
        vals=t(rng.rand(B, F).astype(np.float32)),
        labels=t((rng.rand(B) < 0.3).astype(np.float32)),
        rweight=torch.ones(B, device=cuda), row_mask=torch.ones(B,
                                                                device=cuda),
        num_rows=t(B), num_uniq=t(11000))
    pb = panel_chunk_tokens(pb, U)
    params = FMParams(
        w=t(rng.randn(U).astype(np.float32) * 0.1),
        V=t(rng.randn(U, k).astype(np.float32) * 0.1) if k else None,
        v_mask=t((rng.rand(U) < 0.7).astype(np.float32)) if k else None)
    pred = t(rng.randn(B).astype(np.float32))
    xv = fm.fm_predict_panel_xv(params, pb)[1] if k else None
    before = fused.fm_chunk_grad_cuda.launches
    runs = [fm.fm_grad_panel(params, pb, pred, xv) for _ in range(3)]
    # the kernel entry with embeddings; logistic loss keeps the plain one
    assert fused.fm_chunk_grad_cuda.launches - before == (3 if k else 0)
    for gw, gV in runs[1:]:
        assert torch.equal(gw.view(torch.int32), runs[0][0].view(torch.int32))
        if k:
            assert torch.equal(gV.view(torch.int32),
                               runs[0][1].view(torch.int32))


def _chunk_grad_case(dev, k, binary, data, vdt=torch.float32):
    """One panel of 2,048 rows x 39 fields at U 12,288, laid out as the
    replay cache stages it, with the edges the kernel has to take: the
    last 6 fields empty (lane 0 holds their cells, value 0 on a valued
    panel, ~770 chunks: many groups of S), a lane with one token, lanes
    with none, and the trailing pad chunks. xv and V are row slices of
    wider tensors, as on the main path (the forward's sums, the gathered
    fused rows). ``data`` "exact": every value a small multiple of a
    power of two, so every fp32 sum in any order is exact."""
    from difacto_tpu_torch.losses import FMParams
    from difacto_tpu_torch.ops.batch import PanelBatch, panel_chunk_tokens
    rng = np.random.RandomState(8 + k)
    B, F, U = 2048, 39, 12288
    idx = (rng.zipf(1.2, (B, F)) % 11000).astype(np.int32)
    idx[:, F - 6:] = 0
    idx[5, 3] = 11500                         # a lane of one token
    if data == "exact":
        vals = rng.randint(0, 5, (B, F)) / 4.0
        p = rng.randint(-8, 9, B) / 8.0
        xv = rng.randint(-8, 9, (B, k)) / 8.0
    else:
        vals = rng.rand(B, F)
        p = rng.randn(B)
        xv = rng.randn(B, k)
    vals[:, F - 6:] = 0.0
    t = functools.partial(torch.tensor, device=dev)
    pb = PanelBatch(idx=t(idx), vals=None if binary else t(vals,
                                                          dtype=torch.float32),
                    labels=None, rweight=None, row_mask=None, num_rows=t(B),
                    num_uniq=t(11001))
    pb = panel_chunk_tokens(pb, U)
    wide = torch.zeros((B, 2 * k + 1), device=dev)
    wide[:, 1:1 + k] = t(xv, dtype=torch.float32)
    rows = torch.zeros((U, k + 8), dtype=vdt, device=dev)
    rows[:, :k] = t(rng.randn(U, k), dtype=vdt)
    params = FMParams(w=torch.zeros(U, device=dev), V=rows[:, :k],
                      v_mask=t((rng.rand(U) < 0.7).astype(np.float32)))
    return params, pb, t(p, dtype=torch.float32), wide[:, 1:1 + k]


def _chunk_grad_scale(params, pb, p, xv):
    """Per element, the sum of its terms' magnitudes (the plain version
    over |p|, |xv|, |x| and V = -|V|): what a float32 sum's rounding
    error scales with."""
    from difacto_tpu_torch.losses import fm
    cv = pb.chunk_vals
    return fm.fm_grad_panel_chunked_ref(
        params._replace(V=-params.V.abs()),
        pb._replace(chunk_vals=None if cv is None else cv.abs()),
        p.abs(), xv.abs())


@pytest.mark.parametrize("data", ["exact", "random"])
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("k", [4, 16, 64])
def test_chunk_grad_kernel_matches_plain_and_repeats(cuda, k, binary, data):
    """The chunked backward's kernel against its plain version on the
    card: equal on exactly representable data (only the sums' grouping
    differs, and every grouping is exact there); on random data within
    1e-5 of each element's sum of magnitudes, since a lane's tokens are
    added in another grouping (a chunk's slots in order, long lanes in
    groups of S chunks) and each float32 sum rounds by at most about
    2^-24 times that sum per add along its chain. Three runs equal bit
    for bit; one launch a call."""
    from difacto_tpu_torch.losses import fm
    from difacto_tpu_torch.ops import fused
    params, pb, p, xv = _chunk_grad_case(cuda, k, binary, data)
    S = fused.CHUNK_GRAD_GROUP
    cl = pb.chunk_lane.cpu().numpy()
    U = params.w.shape[0]
    lens = np.bincount(cl[cl < U], minlength=U)
    assert lens[0] > 3 * S and (cl == U).any() and (lens == 0).any()
    assert (pb.chunk_idx[pb.chunk_lane == 11500] < 2048).sum() == 1
    before = fused.fm_chunk_grad_cuda.launches
    runs = [fm._fm_grad_panel_chunked(params, pb, p, xv) for _ in range(3)]
    assert fused.fm_chunk_grad_cuda.launches - before == 3
    want = fm.fm_grad_panel_chunked_ref(params, pb, p, xv)
    torch.cuda.synchronize()
    for gw, gV in runs[1:]:
        assert torch.equal(gw.view(torch.int32), runs[0][0].view(torch.int32))
        assert torch.equal(gV.view(torch.int32), runs[0][1].view(torch.int32))
    got = runs[0]
    assert got[0].shape == (U,) and got[1].shape == (U, k)
    assert got[0].is_contiguous() and got[1].is_contiguous()
    if data == "exact":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        for g, w, s in zip(got, want, _chunk_grad_scale(params, pb, p, xv)):
            assert ((g - w).abs() <= 1e-5 * s).all(), \
                float(((g - w).abs() / s.clamp_min(1e-30)).max())


def test_chunk_grad_kernel_takes_bf16_rows(cuda):
    """A bf16 container's V (Vm rounded to bf16 as torch rounds V * vm):
    equal to the plain version on exactly representable data."""
    from difacto_tpu_torch.losses import fm
    params, pb, p, xv = _chunk_grad_case(cuda, 16, False, "exact",
                                         torch.bfloat16)
    got = fm._fm_grad_panel_chunked(params, pb, p, xv)
    want = fm.fm_grad_panel_chunked_ref(params, pb, p, xv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chunk_grad_kernel_refuses_what_it_cannot_take(cuda, monkeypatch):
    from difacto_tpu_torch.losses import fm
    from difacto_tpu_torch.ops import fused
    params, pb, p, xv = _chunk_grad_case(cuda, 16, False, "random")
    args = dict(p=p, xv=xv, chunk_idx=pb.chunk_idx,
                chunk_lane=pb.chunk_lane, chunk_vals=pb.chunk_vals,
                V=params.V, v_mask=params.v_mask)
    ci = pb.chunk_idx
    C = ci.shape[0]
    bad = [
        (TypeError, dict(p=p.double())),
        (TypeError, dict(chunk_idx=ci.long())),
        (TypeError, dict(V=params.V.half())),
        (ValueError, dict(p=p.cpu())),
        (ValueError, dict(chunk_lane=torch.stack(
            [pb.chunk_lane, pb.chunk_lane], 1)[:, 0])),
        (ValueError, dict(xv=xv.t().contiguous().t())),
        (ValueError, dict(xv=xv[:, :15])),
        (ValueError, dict(chunk_vals=pb.chunk_vals[:, :8])),
        (ValueError, dict(v_mask=params.v_mask[:-1])),
        (ValueError, dict(chunk_idx=ci.view(-1)[1:1 + (C - 1) * 16].view(
            C - 1, 16), chunk_lane=pb.chunk_lane[:C - 1],
            chunk_vals=pb.chunk_vals[:C - 1])),
    ]
    before = fused.fm_chunk_grad_cuda.launches
    for err, over in bad:
        with pytest.raises(err):
            fused.fm_chunk_grad_cuda(**{**args, **over})
    # V wider than a block's columns: refused, and the backward takes the
    # plain version
    k = fused.CHUNK_GRAD_MAX_K + 1
    wide = params._replace(V=torch.zeros((params.V.shape[0], k),
                                         device=cuda))
    xw = torch.zeros((p.shape[0], k), device=cuda)
    with pytest.raises(ValueError):
        fused.fm_chunk_grad_cuda(**{**args, "V": wide.V, "xv": xw})
    got = fm._fm_grad_panel_chunked(wide, pb, p, xw)
    assert got[1].shape == (params.V.shape[0], k)
    # the group size is the wrapper's constant and the kernel's: a launch
    # naming another is refused by the library before any kernel runs
    monkeypatch.setattr(fused, "CHUNK_GRAD_GROUP", fused.CHUNK_GRAD_GROUP // 2)
    with pytest.raises(RuntimeError):
        fused.fm_chunk_grad_cuda(**args)
    assert fused.fm_chunk_grad_cuda.launches == before


@pytest.mark.parametrize("case", ["dp2", "plane"])
def test_chunk_grad_dp_blocks_on_the_card_take_the_plain_version(
        cuda, case, monkeypatch):
    """On the card, dp blocks (``dp=2``) and a data plane keep the plain
    version, whose per-block partials are summed in dp order: the kernel
    entry is never called, and the result is the plain version's bit for
    bit."""
    from difacto_tpu_torch.losses import fm
    from difacto_tpu_torch.ops import fused
    params, pb, p, xv = _chunk_grad_case(cuda, 16, False, "random")

    class OneProcess:
        """A data plane of one process: the gather is its own partials."""

        def gather(self, t):
            return t[None]

    def kernel(*a, **kw):
        raise AssertionError("the kernel entry was called for dp blocks")

    plain = []
    real = fm.fm_grad_panel_chunked_ref

    def ref(*a, **kw):
        plain.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(fused, "fm_chunk_grad_cuda", kernel)
    monkeypatch.setattr(fm, "fm_grad_panel_chunked_ref", ref)
    dp, plane = (2, None) if case == "dp2" else (1, OneProcess())
    got = fm._fm_grad_panel_chunked(params, pb, p, xv, dp=dp, plane=plane)
    assert len(plain) == 1
    want = real(params, pb, p, xv, dp=dp, plane=plane)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_replay_training_launches_the_chunk_grad_kernel(cuda, criteo_file):
    """A replayed FM run on the card: every training step, each staged
    batch's in epoch 0 and every replay, takes the chunked backward's
    kernel entry once; the run repeats bit for bit."""
    from difacto_tpu_torch.learners import sgd as tsgd
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.ops import fused
    kw = [("data_in", criteo_file), ("data_format", "criteo"),
          ("V_dim", "4"), ("batch_size", "100"), ("hash_capacity", "4096"),
          ("num_jobs_per_epoch", "1"), ("max_num_epochs", "3"),
          ("stop_rel_objv", "0"), ("report_interval", "0"),
          ("num_producers", "1"), ("producer_mode", "thread")]
    tables = []
    for _ in range(2):
        ln = SGDLearner(device="cuda")
        assert ln.init(kw) == []
        before = fused.fm_chunk_grad_cuda.launches
        ln.run()
        staged = sum(len(items) for items in
                     ln._caches[tsgd.K_TRAINING].entries.values())
        assert staged == 15
        assert fused.fm_chunk_grad_cuda.launches - before == 3 * staged
        tables.append(ln.store.state.VVg.view(torch.int32).clone())
    assert torch.equal(tables[0], tables[1])


def test_dictionary_replay_run_repeats_and_equals_plain(cuda, tmp_path):
    """A dictionary run from a 64-row table (growing while the cache
    stages, repadded before the replays) on the card: twice the same
    table and key map bit for bit, and the same again with the kernels
    swapped for their plain versions."""
    from difacto_tpu_torch.learners.sgd import SGDLearner
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "rcv1_100.libsvm")
    kw = [("data_in", data), ("V_dim", "4"), ("init_capacity", "64"),
          ("max_num_epochs", "3"), ("l1", "0.1"), ("V_threshold", "1"),
          ("report_interval", "0")]

    def run():
        ln = SGDLearner(device="cuda")
        ln.init(kw)
        ln.run()
        assert ln.device_cache_info()[3]["complete"]
        return ln.store.state.VVg.clone(), ln.store._keys.copy()

    counters = (fused.gather_rows_cuda, fused.fm_update_rows_cuda,
                fused.scatter_rows_cuda)
    before = [c.launches for c in counters]
    t1, k1 = run()
    assert all(c.launches > b for c, b in zip(counters, before))
    t2, k2 = run()
    saved = (fused.gather_rows, fused.fm_update_rows, fused.scatter_rows)
    fused.gather_rows = fused.gather_rows_ref
    fused.fm_update_rows = (lambda table, slots, rows, gw, gV, vm, epi,
                            epilogue: fused.fm_update_rows_ref(
                                table, slots, rows, gw, gV, vm, epilogue))
    fused.scatter_rows = fused.scatter_rows_ref
    try:
        mid = [c.launches for c in counters]
        t3, k3 = run()
        assert [c.launches for c in counters] == mid
    finally:
        fused.gather_rows, fused.fm_update_rows, fused.scatter_rows = saved
    assert t1.shape[0] > 64
    for t, k in ((t2, k2), (t3, k3)):
        assert torch.equal(t.view(torch.int32), t1.view(torch.int32))
        np.testing.assert_array_equal(k, k1)


@pytest.mark.parametrize("kind", ["random", "all_equal", "all_distinct"])
def test_dedup_tokens_on_the_card_equal_the_cpu(cuda, kind):
    """The device dedup of a main-path-sized batch of raw tokens (1000 x
    39 cells, n_uniq = u_cap - 1) equals the CPU's bit for bit."""
    rng = np.random.RandomState(3)
    u_cap = 12288
    if kind == "random":
        vals = rng.choice(np.arange(1, 1 << 22), u_cap - 1, replace=False)
        tok = np.concatenate([vals, rng.choice(vals, 39000 - len(vals))])
        tok = rng.permutation(tok)
    elif kind == "all_equal":
        tok = np.full(39000, 12345)
    else:
        tok = rng.permutation(np.arange(1, u_cap))
    tok = torch.from_numpy(tok.astype(np.int32))
    cpu = fused.dedup_tokens(tok, u_cap, 1 << 22)
    for _ in range(2):
        got = fused.dedup_tokens(tok.to(cuda), u_cap, 1 << 22)
        for g, c in zip(got, cpu):
            assert torch.equal(g.cpu(), c)


def _stream_run(cuda, data, *extra):
    from difacto_tpu_torch.learners.sgd import SGDLearner
    ln = SGDLearner(device="cuda")
    ln.init([("data_in", data), ("data_format", "criteo"), ("V_dim", "4"),
             ("hash_capacity", "65536"), ("batch_size", "100"),
             ("num_jobs_per_epoch", "3"), ("max_num_epochs", "3"),
             ("device_cache_mb", "0"), ("l1", "0.1"), ("V_threshold", "1"),
             ("report_interval", "0")] + list(extra))
    ln.run()
    return ln.store.state.VVg.view(torch.int32).clone(), ln.stage_stats()


@pytest.fixture(scope="module")
def criteo_file(tmp_path_factory):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import synthetic_criteo
    path = tmp_path_factory.mktemp("criteo_card") / "train.txt"
    path.write_bytes(synthetic_criteo(1500, 7))
    return str(path)


def test_device_dedup_on_the_card_equals_host_dedup(cuda, criteo_file):
    """Streamed training on the card: device_dedup=1 (raw tokens, the
    dedup in the step) leaves the host-dedup run's table bit for bit."""
    host, _ = _stream_run(cuda, criteo_file, ("num_producers", "1"),
                          ("producer_mode", "thread"))
    dev, _ = _stream_run(cuda, criteo_file, ("num_producers", "1"),
                         ("producer_mode", "thread"), ("device_dedup", "1"))
    assert torch.equal(dev, host)


def test_process_and_thread_producers_on_the_card_agree(cuda, criteo_file):
    """Worker processes over the ring and producer threads leave the same
    table on the card, bit for bit."""
    thread, ts = _stream_run(cuda, criteo_file, ("num_producers", "2"),
                             ("producer_mode", "thread"))
    proc, ps = _stream_run(cuda, criteo_file, ("num_producers", "2"),
                           ("producer_mode", "process"))
    assert ts["producer_mode"] == "thread"
    assert ps["producer_mode"] == "process"
    assert torch.equal(proc, thread)


@pytest.mark.parametrize("seed", range(3))
def test_logit_delta_on_the_card_equals_the_cpu(cuda, seed):
    """BCD's two reductions on the card: ``delta_pred_update`` (products
    and ordered sums only) equals the CPU's bit for bit, ``delta_grad``
    within 1e-6 of max|g| (the card's ``exp``), and both repeat."""
    from difacto_tpu_torch.losses.logit_delta import (BlockSlice,
                                                      delta_grad,
                                                      delta_pred_update)
    rng = np.random.RandomState(seed)
    b_cap, nnz, cap, nf = 12288, 300000, 393216, 6144
    rows = np.zeros(cap, np.int32)
    rows[:nnz] = np.sort(rng.randint(0, 12000, nnz))
    cols = np.zeros(cap, np.int32)
    cols[:nnz] = rng.zipf(1.3, nnz) % nf
    vals = np.zeros(cap, np.float32)
    vals[:nnz] = rng.randn(nnz)
    pred = torch.from_numpy((rng.randn(b_cap) * 2).astype(np.float32))
    labels = torch.from_numpy((rng.rand(b_cap) < 0.3).astype(np.float32))
    mask = torch.from_numpy((np.arange(b_cap) < 12000).astype(np.float32))
    d = torch.from_numpy(rng.randn(nf).astype(np.float32))
    blk = BlockSlice(*map(torch.from_numpy, (rows, cols, vals)))
    on = BlockSlice(*(x.to(cuda) for x in blk))
    cpu = delta_grad(pred, labels, mask, blk, nf)
    a = delta_grad(pred.to(cuda), labels.to(cuda), mask.to(cuda), on, nf)
    b = delta_grad(pred.to(cuda), labels.to(cuda), mask.to(cuda), on, nf)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    err = (a.cpu() - cpu).abs().max(dim=0).values
    assert (err <= 1e-6 * cpu.abs().max(dim=0).values).all()
    cpu = delta_pred_update(pred, blk, d)
    a = delta_pred_update(pred.to(cuda), on, d.to(cuda))
    b = delta_pred_update(pred.to(cuda), on, d.to(cuda))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.parametrize("learner,over", [
    ("bcd", [("l1", ".1"), ("lr", ".8"), ("block_ratio", "1"),
             ("tail_feature_filter", "0"), ("max_num_epochs", "5")]),
    ("lbfgs", [("V_dim", "0"), ("l2", "0"), ("m", "5"),
               ("init_alpha", "1"), ("tail_feature_filter", "0"),
               ("max_num_epochs", "8")]),
    ("lbfgs", [("V_dim", "5"), ("l2", "0.1"), ("V_l2", "0.01"),
               ("m", "5"), ("tail_feature_filter", "0"),
               ("max_num_epochs", "8"), ("tile_cache_mb", "1")])])
def test_batch_learners_on_the_card_repeat_and_track_the_cpu(cuda, learner,
                                                            over):
    """Two runs on the card give the same progress and weights bit for
    bit; the CPU run's progress agrees within 1e-5 relative, the FM's
    objective within 1e-4 relative (over 8 epochs the line search carries
    the card's float32 reduction order: 1.9e-5 relative measured on an
    H100)."""
    from difacto_tpu_torch.learners.base import Learner
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "rcv1_100.libsvm")
    runs = []
    for dev in (cuda, cuda, "cpu"):
        ln = Learner.create(learner, device=dev)
        assert ln.init([("data_in", data)] + over) == []
        progs = []
        ln.add_epoch_end_callback(lambda e, p: progs.append(p))
        ln.run()
        w = torch.as_tensor(ln.w) if learner == "bcd" else ln.weights.cpu()
        runs.append((progs, w))
    (pa, wa), (pb, wb), (pc, _) = runs
    assert pa == pb
    assert torch.equal(wa.view(torch.int32), wb.view(torch.int32))
    fm = learner == "lbfgs" and dict(over)["V_dim"] != "0"
    for a, c in zip(pa, pc):
        if fm:
            assert abs(a.objv - c.objv) <= 1e-4 * abs(c.objv)
        else:
            assert abs(a.objv - c.objv) <= 1e-5 * abs(c.objv) + 1e-6
        assert abs(a.auc - c.auc) <= 1e-5 * abs(c.auc)


def _card_and_cpu(cuda, **kw):
    """The same store on the CPU and on the card: the card's table starts
    as a copy of the CPU's (the two generators draw different streams)."""
    from difacto_tpu_torch.store.local import SlotStore
    base = dict(hash_capacity=4096, V_dim=16, V_threshold=0, lr=0.1,
                V_lr=0.1)
    base.update(kw)
    p, rest = T.SGDUpdaterParam.init_allow_unknown(
        [(k, str(v)) for k, v in base.items()])
    assert rest == []
    cpu = SlotStore(p, device="cpu")
    card = SlotStore(p, device="cuda", init=lambda C: T.SGDState(
        *(a.to(cuda) for a in cpu.state)))
    return cpu, card


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "fp8"])
def test_tier_churn_on_the_card_equals_the_cpu(cuda, kind):
    """Batches of 1,500 slots over a 1,024-row device table: the card's
    promotes (the scatter kernel, epilogue off) and demotes (the gather
    kernel) leave the CPU tier's residency, host rows and table bit for
    bit."""
    cpu, card = _card_and_cpu(cuda, slot_dtype=kind, cold_tier_rows=3072)
    rng = np.random.default_rng(1)
    g0 = fused.gather_rows_cuda.launches
    s0 = fused.scatter_rows_cuda.launches
    for _ in range(6):
        v = np.sort(rng.choice(np.arange(1, 4096), 700, replace=False))
        v = np.concatenate([v, 4096 + np.arange(68)]).astype(np.int32)
        for a, b in zip(cpu.tier.route(v), card.tier.route(v)):
            np.testing.assert_array_equal(a, b)
    torch.cuda.synchronize()
    t = card.tier
    assert fused.gather_rows_cuda.launches - g0 == t.calls["demote"] > 0
    assert fused.scatter_rows_cuda.launches - s0 == t.calls["promote"] > 0
    for name in ("_resident", "_owner", "_clock"):
        np.testing.assert_array_equal(getattr(cpu.tier, name),
                                      getattr(t, name))
    assert sorted(cpu.tier._rows) == sorted(t._rows)
    assert all(cpu.tier._rows[s].tobytes() == t._rows[s].tobytes()
               for s in t._rows)
    assert torch.equal(card.state.VVg.cpu().view(torch.int8),
                       cpu.state.VVg.view(torch.int8))


def test_tiered_run_on_the_card_repeats_and_equals_plain(cuda, criteo_file):
    """A streamed run with the cold tier, admission and eviction on the
    card: twice the same table, and the same on the plain versions."""
    extra = (("cold_tier_rows", "49152"), ("admit_min_count", "2"),
             ("evict_occupancy", "0.05"), ("num_producers", "2"),
             ("producer_mode", "thread"))
    t1, _ = _stream_run(cuda, criteo_file, *extra)
    t2, _ = _stream_run(cuda, criteo_file, *extra)
    saved = (fused.gather_rows, fused.scatter_rows, fused.fm_update_rows)
    fused.gather_rows = fused.gather_rows_ref
    fused.scatter_rows = fused.scatter_rows_ref
    fused.fm_update_rows = (lambda table, slots, rows, gw, gV, vm, epi,
                            epilogue: fused.fm_update_rows_ref(
                                table, slots, rows, gw, gV, vm, epilogue))
    try:
        t3, _ = _stream_run(cuda, criteo_file, *extra)
    finally:
        fused.gather_rows, fused.scatter_rows, fused.fm_update_rows = saved
    assert t1.shape[0] == 65536 - 49152
    assert torch.equal(t1, t2) and torch.equal(t1, t3)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_wal_round_trip_on_the_card(cuda, tmp_path, kind):
    """Rows the card's gather logs, through a segment on disk, land by the
    card's scatter (and by the CPU's) as the same bytes."""
    from difacto_tpu_torch.durability import wal
    cpu, card = _card_and_cpu(cuda, slot_dtype=kind)
    rng = np.random.default_rng(2)
    bits = card.state.VVg.view(torch.int8)
    bits.copy_(torch.randint(-128, 128, bits.shape, dtype=torch.int8,
                             device=cuda))
    slots = np.sort(rng.choice(np.arange(1, 4096), 1500, replace=False))
    path = str(tmp_path / "s.dfwal")
    wal.write_segment(path, card.wal_geometry(),
                      {"slots": slots.astype(np.int32),
                       **card.wal_touched_rows(slots)})
    _, arrays = wal.read_segment(path)
    got = arrays.pop("slots")
    for store in (cpu, _card_and_cpu(cuda, slot_dtype=kind)[1]):
        store.apply_wal_rows(got, dict(arrays))
        want = card.state.VVg[torch.from_numpy(slots).to(cuda)]
        have = store.state.VVg[torch.from_numpy(slots).to(
            store.state.VVg.device)]
        assert torch.equal(have.cpu().view(torch.int8),
                           want.cpu().view(torch.int8))


def test_wal_run_on_the_card_equals_wal_off(cuda, criteo_file, tmp_path):
    """The WAL observes: a WAL-on streamed run on the card leaves the
    WAL-off run's table bit for bit."""
    off, _ = _stream_run(cuda, criteo_file, ("num_producers", "2"),
                         ("producer_mode", "thread"))
    on, _ = _stream_run(cuda, criteo_file, ("num_producers", "2"),
                        ("producer_mode", "thread"),
                        ("wal_flush_batches", "3"),
                        ("model_out", str(tmp_path / "m")),
                        ("ckpt_interval", "1"))
    assert torch.equal(on, off)
    assert os.listdir(str(tmp_path / "m.wal"))


# ------------------------------------------------------------- reload
_RCV1 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "rcv1_100.libsvm")


def _saved_model(path, V_dim, C, seed):
    """A saved random FM model (written from the CPU)."""
    from difacto_tpu_torch.store.convert import state_from_numpy
    from difacto_tpu_torch.store.local import SlotStore
    p = T.SGDUpdaterParam(V_dim=V_dim, hash_capacity=C)
    rng = np.random.RandomState(seed)
    st = SlotStore(p, device="cpu")
    st.state = state_from_numpy(p, {
        "w": (rng.randn(C) * 0.1).astype(np.float32),
        "v_live": rng.rand(C) < 0.5,
        "V": ((rng.rand(C, V_dim) - 0.5) * 0.2).astype(np.float32)},
        device="cpu")
    st.save(path + "_part-0")
    return path


def _column(model, dev):
    """The probability column ``task=pred`` formats for the fixture rows,
    scored on ``dev`` (a row's score does not depend on its batch)."""
    from difacto_tpu_torch.data.parsers import parse_libsvm
    from difacto_tpu_torch.serve import PredictExecutor, open_serving_store
    from difacto_tpu_torch.serve.executor import sigmoid
    store, _, _ = open_serving_store(model, device=dev)
    with open(_RCV1, "rb") as f:
        scores = PredictExecutor(store).predict_scores(parse_libsvm(f.read()))
    return [(b"%g" % float(x)) for x in sigmoid(scores)]


@pytest.mark.parametrize("new", ["same_geometry", "bluegreen"])
def test_reload_on_the_card_while_scoring(cuda, tmp_path, new):
    """A ``#reload`` on the card under pipelined load: every answer is the
    old or the new model's for its row (no batch torn across models),
    answers after the swap are the new model's, the gather launched on the
    card, the peak held both tables, and the old table's memory is
    returned once it is dropped."""
    import gc
    import threading

    from difacto_tpu_torch.serve import (ModelReloader, ServeClient,
                                         ServeServer, open_serving_store)
    C = 1 << 18
    old = _saved_model(str(tmp_path / "old"), 4, C, 1)
    newm = _saved_model(str(tmp_path / "new"), 4 if new == "same_geometry"
                        else 8, C if new == "same_geometry" else C // 2, 2)
    old_col, new_col = _column(old, cuda), _column(newm, cuda)
    assert sum(a != b for a, b in zip(old_col, new_col)) > 50
    with open(_RCV1, "rb") as f:
        rows = [r for r in f.read().splitlines() if r.strip()]
    gc.collect()
    torch.cuda.empty_cache()
    store, _, _ = open_serving_store(old, device=cuda)
    table_bytes = store.state.VVg.numel() * store.state.VVg.element_size()
    srv = ServeServer(store, batch_size=16, max_delay_ms=1.0).start()
    del store
    srv.reloader = ModelReloader(srv.executor, old, server=srv)
    seen, stop = [], threading.Event()

    def load():
        with ServeClient(srv.host, srv.port) as c:
            while not stop.is_set():
                seen.append(c.score_lines(rows))

    t = threading.Thread(target=load)
    try:
        launches = fused.gather_rows_cuda.launches
        with ServeClient(srv.host, srv.port) as c:
            assert c.score_lines(rows) == old_col
            t.start()
            while len(seen) < 2:
                time.sleep(0.01)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(cuda)
            torch.cuda.reset_peak_memory_stats(cuda)
            res = c.reload(newm)
            assert res["ok"] and res["model_generation"] == 2, res
            peak = torch.cuda.max_memory_allocated(cuda)
            vvg = srv.executor.store.state.VVg
            new_bytes = vvg.numel() * vvg.element_size()
            del vvg
            n = len(seen)
            while len(seen) < n + 3:
                time.sleep(0.01)
            stop.set()
            t.join(timeout=60)
            assert c.score_lines(rows) == new_col
            st = c.stats()
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(cuda)
    finally:
        stop.set()
        srv.close()
    assert not t.is_alive() and st["errors"] == 0
    for resp in seen:
        for i, r in enumerate(resp):
            assert r in (old_col[i], new_col[i]), (i, r)
    assert seen[-1] == new_col
    assert fused.gather_rows_cuda.launches > launches
    assert st["bluegreen_swaps"] == (1 if new == "bluegreen" else 0)
    # both tables were held across the swap
    assert peak >= base + new_bytes - (16 << 20), (base, peak, new_bytes)
    # the old table went back: what is held now is about the new table
    # where the old one was
    assert after <= base - table_bytes + new_bytes + (64 << 20), \
        (base, after, table_bytes)


@pytest.mark.parametrize("balance", ["p2c", "affinity"])
def test_router_over_two_card_replicas_equals_pred(cuda, tmp_path, balance):
    """The router in front of two replicas on the card: every answer is
    the model's pred column, both replicas launched the gather (one launch
    per dispatch), and the router's ``#stats`` counts every row."""
    from difacto_tpu_torch.serve import (RouterServer, ServeClient,
                                         ServeServer, open_serving_store)
    model = _saved_model(str(tmp_path / "m"), 4, 1 << 18, 3)
    col = _column(model, cuda)
    with open(_RCV1, "rb") as f:
        rows = [r for r in f.read().splitlines() if r.strip()]
    reps = []
    for _ in range(2):
        store, _, _ = open_serving_store(model, device=cuda)
        reps.append(ServeServer(store, batch_size=32,
                                max_delay_ms=1.0).start())
    router = None
    launches = fused.gather_rows_cuda.launches
    try:
        # the splitmix64 ring (capacity 0) spreads rcv1's leading keys;
        # the capacity arithmetic would put them all in one range
        router = RouterServer([(s.host, s.port) for s in reps],
                              balance=balance).start()
        with ServeClient(router.host, router.port) as c:
            got = [c.score_lines(rows) for _ in range(3)]
            st = c.stats()
        dispatches = [s.executor.stats()["dispatches"] for s in reps]
    finally:
        if router is not None:
            router.close()
        for s in reps:
            s.close()
    assert all(g == col for g in got)
    assert st["rows"] == 300 and st["errors"] == 0, st
    assert all(b["rows"] > 0 for b in st["backends"]), st
    assert all(d > 0 for d in dispatches), dispatches
    assert fused.gather_rows_cuda.launches - launches == sum(dispatches)


def test_rolling_restart_on_the_card_returns_memory(cuda, tmp_path):
    """Two replicas on the card rolled behind the router, each successor
    built on the card beside its incumbent: the answers stay the pred
    column, the peak is the fleet plus one store load (one successor at a
    time; each incumbent is dropped once it has closed), the allocated
    memory after the roll is the fleet's two tables again, and closing
    everything returns it all."""
    import gc

    from difacto_tpu_torch.serve import (RouterServer, ServeClient,
                                         ServeServer, open_serving_store,
                                         run_rolling_restart)
    C = 1 << 20
    model = _saved_model(str(tmp_path / "m"), 8, C, 4)
    col = _column(model, cuda)
    with open(_RCV1, "rb") as f:
        rows = [r for r in f.read().splitlines() if r.strip()]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    store, _, _ = open_serving_store(model, device=cuda)
    del store
    gc.collect()
    torch.cuda.synchronize()
    load_peak = torch.cuda.max_memory_allocated(cuda) - base

    def serve(**kw):
        store, _, _ = open_serving_store(model, device=cuda)
        return ServeServer(store, batch_size=32, max_delay_ms=1.0,
                           takeover=True, **kw).start()

    incumbents = [serve(), serve()]
    eps = [(s.host, s.port) for s in incumbents]
    successors = []

    def spawn(i, host, port, ready_file):
        if i:
            # the roll hands off to replica i only once incumbent i-1
            # has closed its connections; drop it so its table goes
            prev = incumbents[i - 1]
            prev.wait(60.0)
            prev._handoff_thread.join(60.0)
            assert prev._is_closed()
            incumbents[i - 1] = prev = None
            gc.collect()
        s = serve(host=host, port=port)
        s.ready_file = ready_file
        with open(ready_file, "w") as f:
            f.write(f"{host} {port}\n")
        successors.append(s)

    router = RouterServer(eps).start()
    try:
        torch.cuda.synchronize()
        fleet = torch.cuda.memory_allocated(cuda) - base
        table = fleet // 2
        torch.cuda.reset_peak_memory_stats(cuda)
        with ServeClient(router.host, router.port) as c:
            assert c.score_lines(rows) == col
            roll = run_rolling_restart(eps, spawn_fn=spawn, wait_s=120.0)
            assert roll["ok"], roll
            assert c.score_lines(rows) == col
        peak = torch.cuda.max_memory_allocated(cuda) - base
        assert incumbents[1]._is_closed()
        del incumbents[:]
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(cuda) - base
    finally:
        router.close()
        for srv in incumbents + successors:
            if srv is not None:
                srv.close()
        srv = None
    del successors[:]
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(cuda) - base
    assert table > 0 and peak <= fleet + load_peak + (64 << 20), \
        (peak, fleet, table, load_peak)
    assert abs(held - fleet) <= (64 << 20), (held, fleet)
    assert after <= (64 << 20), after


# ------------------------------------------------- the mesh (PR slice 12)
@pytest.mark.parametrize("real", [[3, 15, 16, 17, 40, 63], [33, 34, 40], [],
                                  [16], [1, 2, 50]])
def test_sharded_kernels_equal_the_flat_kernels(cuda, real):
    """The routed pull and push over four key-range shards of a table on
    the card launch the kernels once per non-empty shard run and leave
    the flat kernels' bytes: the gathered rows and the pushed table."""
    import functools
    from difacto_tpu_torch.parallel import sharded
    from difacto_tpu_torch.store.slots import pad_slots_oob
    C, fs, u = 64, 4, 8
    param = T.SGDUpdaterParam(V_dim=4, hash_capacity=C, l1=0.01,
                              V_threshold=0)
    base = T.init_state(param, C, cuda).VVg
    host = pad_slots_oob(np.array(real, np.int32), u, C)
    ss = sharded.route(torch.from_numpy(host).to(cuda), host, C, fs)
    n = C // fs
    runs = sum(1 for _ in sharded._runs(ss))

    def shards(t):
        return [t[f * n:(f + 1) * n] for f in range(fs)]

    before = fused.gather_rows_cuda.launches
    got = sharded.sharded_gather(shards(base), ss)
    assert fused.gather_rows_cuda.launches - before == runs
    want = fused.gather_rows_cuda(base, ss.slots)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    g = torch.Generator(device=cuda).manual_seed(1)
    gw = torch.randn(u, generator=g, device=cuda)
    gV = torch.randn(u, 4, generator=g, device=cuda)
    vm = (torch.rand(u, generator=g, device=cuda) > 0.3).float()
    epi = T.epilogue_spec(param, C)
    plain = functools.partial(T.row_epilogue, param, C)
    flat = base.clone()
    fused.fm_update_rows_cuda(flat, ss.slots, want, gw, gV, vm, epi)
    routed = base.clone()
    before = fused.fm_update_rows_cuda.launches
    sharded.sharded_push(shards(routed), ss, want, gw, gV, vm, epi, plain)
    assert fused.fm_update_rows_cuda.launches - before == runs
    assert torch.equal(routed.view(torch.int32), flat.view(torch.int32))


def test_mesh_learner_on_the_card_leaves_the_flat_table(cuda, monkeypatch):
    """rcv1 at ``mesh_fs=4`` on the card (eight logical devices) leaves
    the flat run's table bit for bit; the 2 x 4 mesh repeats bit for
    bit."""
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.parallel import sharded
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")
    kw = [("data_in", _RCV1), ("V_dim", "2"), ("V_threshold", "2"),
          ("lr", "0.1"), ("l1", "0.1"), ("l2", "0"),
          ("num_jobs_per_epoch", "1"), ("batch_size", "30"),
          ("max_num_epochs", "3"), ("shuffle", "0"),
          ("report_interval", "0"), ("stop_rel_objv", "0"),
          ("hash_capacity", "4096")]

    def run(extra):
        ln = SGDLearner(device="cuda")
        assert ln.init(kw + extra) == []
        ln.run()
        return sharded.host_state(ln.store.state).VVg.view(torch.int32)

    flat = run([])
    assert torch.equal(run([("mesh_fs", "4")]), flat)
    a = run([("mesh_dp", "2"), ("mesh_fs", "4")])
    assert torch.equal(run([("mesh_dp", "2"), ("mesh_fs", "4")]), a)


def _blocks(dev):
    g = torch.Generator().manual_seed(5)
    data = torch.randn(512, 18, generator=g).to(dev)
    lanes = torch.sort(torch.randint(0, 300, (512,), generator=g,
                                     dtype=torch.int32)).values.to(dev)
    return data, lanes


def test_data_plane_on_the_card_sums_in_order(cuda, tmp_path):
    """Two processes on the card (launch.py, gloo): each gathers its dp
    block's partials through pinned host memory and sums every block in
    rank order on the card; the result equals one process's dp_reduce
    over both blocks on the same card, bit for bit, on both ranks."""
    import socket
    import subprocess
    import sys

    from difacto_tpu_torch.losses.fm import dp_reduce
    from difacto_tpu_torch.ops.segment import lane_sum
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data, lanes = _blocks(cuda)
    want = dp_reduce(lane_sum, data, lanes, 300, dp=2).cpu()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "launch.py"), "-n", "2",
         "--port", str(port), "--", sys.executable, __file__, "dataplane",
         str(tmp_path)], cwd=root, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for r in (0, 1):
        got = torch.from_numpy(np.load(tmp_path / f"sum-{r}.npy"))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


if __name__ == "__main__":
    import sys

    from difacto_tpu_torch.losses.fm import dp_reduce
    from difacto_tpu_torch.ops.segment import lane_sum
    from difacto_tpu_torch.parallel.multihost import (DataPlane, initialize,
                                                      process_index)
    initialize()
    rank = process_index()
    data, lanes = _blocks(torch.device("cuda"))
    mine = slice(rank * 256, (rank + 1) * 256)
    got = dp_reduce(lane_sum, data[mine], lanes[mine], 300, dp=1,
                    plane=DataPlane())
    assert got.device.type == "cuda"
    np.save(os.path.join(sys.argv[2], f"sum-{rank}.npy"), got.cpu().numpy())
