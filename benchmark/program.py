"""Drives the system under test, ``difacto_tpu_torch``'s SGD learner,
through one cell: set-up streams epoch 0 from the generated Criteo text
(thread producers, staging every batch into the replay cache) and
replays epoch 1; the window is the learner's own replayed epochs, a
closed loop, each epoch after the last, until ``seconds`` have passed,
and the first steps of its first epoch are followed for the output
check.

Everything here wraps the program at run time and edits none of its
files: the step recorder around ``learner._train_step``, and in a traced
run ``torch.profiler.record_function`` spans around the learner's
dispatch (``_dispatch_staged``), its metric fetch (``_merge_pending``),
its table evaluation (``store.evaluate_dev``) and the two kernel entries
of ``ops/fused.py`` (``gather_rows``, ``fm_update_rows``), whose
in-bounds slots the spans count on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# the span names the trace reader keys on
SPAN_WINDOW = "bench.window"
SPAN_DISPATCH = "bench.learner.dispatch"
SPAN_FETCH = "bench.learner.fetch"
SPAN_EVALUATE = "bench.learner.evaluate"
SPAN_GATHER = "bench.kernels.gather"
SPAN_PUSH = "bench.kernels.push"

# the flat V_dim 0 table's columns that the check reads, in the order the
# recorder copies them
FLAT_COLS = ("w", "sqrt_g")


class WindowClosed(Exception):
    """Raised from the epoch-end callback to end the learner's run."""


def learner_kwargs(cfg: dict, traffic: dict, data_in: str, seed: int,
                   overrides: Optional[dict] = None) -> list:
    """The learner's ``key=value`` list: the configuration as run, the
    traffic's feed keys, the data file and the table seed."""
    conf = dict(cfg["conf"])
    conf.update(traffic["learner"])
    conf.update(overrides or {})
    conf["data_in"] = data_in
    conf["seed"] = int(seed) & 0xFFFFFFFF
    return [(k, str(int(v) if isinstance(v, bool) else v))
            for k, v in conf.items()]


def build_learner(kwargs: list, device: str):
    from difacto_tpu_torch.learners.base import Learner
    learner = Learner.create("sgd", device=device)
    remain = learner.init(kwargs)
    if remain:
        raise ValueError(f"keys the learner does not take: {remain}")
    return learner


def sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


class Recorder:
    """Wraps ``learner._train_step``: keeps each step's objective (a
    device scalar) up to the last followed step, and around the followed
    steps (the first steps of the window's first epoch) copies the table
    rows they touch, raw, to the host on a side stream, with no host
    sync: before each followed step the rows of its slot vector, after
    the first those rows again, after the last the rows of every
    followed step. Once the window has closed, the copies are read
    through the program's own logical view of its fused rows, or at
    ``V_dim`` 0, where the table is flat columns pushed in place, as the
    columns w and sqrt_g side by side. The wrapper takes itself off after
    the last followed step."""

    def __init__(self, learner, followed: List[int]):
        from difacto_tpu_torch.updaters import sgd_updater as su
        self._su = su
        self.learner = learner
        self.param = learner.store.param
        self.capacity = learner.store.state.capacity
        self.flat = self.param.V_dim == 0
        self.followed = followed
        self.step = 0
        self.objv: List[torch.Tensor] = []
        # per kind, (slot ids, raw rows) host tensors in step order
        self.copies: Dict[str, list] = {"pre": [], "first": [], "last": []}
        self._idx: List[torch.Tensor] = []
        self._bufs: list = []
        self._side = None
        self._orig = learner._train_step
        learner._train_step = self._wrapped

    def prepare(self) -> None:
        """The host buffers of the followed steps' copies, sized by the
        longest staged slot vector, pinned on the card's host so that the
        copies run on the side stream while the window runs on."""
        state = self.learner.store.state
        if self.flat:
            shape, dtype = (len(FLAT_COLS),), state.w.dtype
        else:
            shape, dtype = tuple(state.VVg.shape[1:]), state.VVg.dtype
        u = max(st.u_cap for c in self.learner._caches.values()
                for v in c.entries.values() for st in v)
        pin = state.VVg.is_cuda
        self._bufs = [(torch.empty(u, dtype=torch.int64, pin_memory=pin),
                       torch.empty((u,) + shape, dtype=dtype,
                                   pin_memory=pin))
                      for _ in range(2 * len(self.followed) + 1)]
        if pin:
            self._side = torch.cuda.Stream(device=state.VVg.device)

    def _rows(self, state, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of the table (pads clamped in bounds, dropped
        when read): the fused rows, or the flat columns side by side."""
        idx = idx.clamp(0, self.capacity - 1)
        if not self.flat:
            return state.VVg.index_select(0, idx)
        return torch.stack([getattr(state, c).index_select(0, idx)
                            for c in FLAT_COLS], dim=1)

    def _copy(self, kind: str, state, idx: torch.Tensor) -> None:
        """Enqueue rows ``idx`` of ``state``'s table and the ids for the
        host."""
        ids, rows_h = self._bufs.pop()
        n = idx.shape[0]
        rows = self._rows(state, idx)
        ids, rows_h = ids[:n], rows_h[:n]
        if self._side is None:
            ids.copy_(idx)
            rows_h.copy_(rows)
        else:
            ready = torch.cuda.Event()
            ready.record()
            self._side.wait_event(ready)
            with torch.cuda.stream(self._side):
                ids.copy_(idx, non_blocking=True)
                rows_h.copy_(rows, non_blocking=True)
            idx.record_stream(self._side)
            rows.record_stream(self._side)
        self.copies[kind].append((ids, rows_h))

    def _wrapped(self, state, batch, slots):
        i = self.step
        self.step += 1
        if i not in self.followed:
            out = self._orig(state, batch, slots)
            self.objv.append(out[1])
            return out
        idx = slots.to(torch.int64)
        self._copy("pre", state, idx)
        out = self._orig(state, batch, slots)
        self.objv.append(out[1])
        self._idx.append(idx)
        # the push is in place: these copies queue behind its scatters
        if i == self.followed[0]:
            self._copy("first", out[0], idx)
        if i == self.followed[-1]:
            for j in self._idx:
                self._copy("last", out[0], j)
            self._idx = []
            self.learner._train_step = self._orig
        return out

    def close(self) -> None:
        """Take the wrapper off, if the followed steps did not."""
        if self.learner._train_step == self._wrapped:
            self.learner._train_step = self._orig

    def _logical(self, kind: str):
        """(in-bounds slot ids, {w, sg, V, Vg} float64) of each copy of
        ``kind``, in step order."""
        su, state = self._su, self.learner.store.state
        out = []
        for ids, rows in self.copies[kind]:
            keep = (ids >= 0) & (ids < self.capacity)
            if self.flat:
                w, sg = rows[keep].unbind(1)
                V = Vg = torch.zeros((w.shape[0], 0), dtype=torch.float64)
            else:
                sub = state._replace(VVg=rows[keep].to(state.VVg.device))
                w, _, sg, _, _ = su.scal_cols(self.param, sub,
                                              self.capacity)
                V, Vg = su.emb_cols_f32(self.param, sub, self.capacity)
            out.append((ids[keep].numpy(),
                        {k: v.to(torch.float64).cpu().numpy()
                         for k, v in (("w", w), ("sg", sg), ("V", V),
                                      ("Vg", Vg))}))
        return out

    def results(self) -> dict:
        """The followed steps' readings as host arrays: before them each
        row they touch as the first of them found it, after the first the
        rows it touched, after the last every row they touched."""
        if len(self.copies["last"]) != len(self.followed):
            raise RuntimeError("the followed steps did not all run")
        if self._side is not None:
            self._side.synchronize()

        def by_slot(copies):
            ids = np.concatenate([c[0] for c in copies])
            union, first = np.unique(ids, return_index=True)
            return union, {k: np.concatenate([c[1][k] for c in copies])[
                first] for k in copies[0][1]}

        pre = self._logical("pre")
        union, before = by_slot(pre)
        union_after, after = by_slot(self._logical("last"))
        if not np.array_equal(union, union_after):
            raise RuntimeError("the followed steps' copies disagree")
        return {"objv": [float(o) for o in self.objv],
                "union": union, "before": before,
                "first_slots": pre[0][0], "first_before": pre[0][1],
                "first_after": self._logical("first")[0][1],
                "after": after}


def _in_bounds(slots: torch.Tensor, capacity: int) -> torch.Tensor:
    return (slots >= 0) & (slots < capacity)


@contextlib.contextmanager
def spans(learner, counts: Optional[Dict[str, list]] = None):
    """``record_function`` spans around the calls into each layer. With
    ``counts``, each kernel entry's in-bounds slots (and the push's
    embedding-active ones) are reduced on the device before its span
    opens and kept as device scalars under ``gather_real``,
    ``push_real`` and ``push_vm``."""
    from torch.profiler import record_function
    from difacto_tpu_torch.ops import fused

    def count_gather(table, slots, *a, **kw):
        counts["gather_real"].append(
            _in_bounds(slots, table.shape[0]).sum())

    def count_push(table, slots, rows, gw, gV, vmask, *a, **kw):
        real = _in_bounds(slots, table.shape[0])
        counts["push_real"].append(real.sum())
        counts["push_vm"].append((real & (vmask > 0)).sum())

    def wrap(fn, name, count):
        def inner(*a, **kw):
            if count is not None:
                count(*a, **kw)
            with record_function(name):
                return fn(*a, **kw)
        return inner

    counting = counts is not None
    targets = [(learner, "_dispatch_staged", SPAN_DISPATCH, None),
               (learner, "_merge_pending", SPAN_FETCH, None),
               (learner.store, "evaluate_dev", SPAN_EVALUATE, None),
               (fused, "gather_rows", SPAN_GATHER,
                count_gather if counting else None),
               (fused, "fm_update_rows", SPAN_PUSH,
                count_push if counting else None)]
    # (object, attribute, what it held, whether it held it itself)
    saved = [(o, a, getattr(o, a), a in vars(o)) for o, a, _, _ in targets]
    try:
        for o, a, name, count in targets:
            setattr(o, a, wrap(getattr(o, a), name, count))
        yield
    finally:
        for o, a, fn, own in saved:
            if own:
                setattr(o, a, fn)
            else:
                delattr(o, a)


@dataclasses.dataclass
class Window:
    """What the measured window saw."""
    seconds: float = 0.0
    epochs: int = 0
    rows: int = 0
    steps: int = 0
    failed_steps: int = 0
    peak_bytes: int = 0
    dispatch_s: float = 0.0
    dispatch_n: int = 0
    traced: Optional[dict] = None


def _hist(learner, name: str):
    """(sum, count) of a histogram of the learner's registry."""
    series = learner.obs.snapshot().get("hists", {}).get(name, {})
    s = sum(d["sum"] for d in series.values())
    n = sum(sum(d["counts"]) for d in series.values())
    return s, n


def run(learner, device: str, setup_epochs: int, seconds: float,
        trace_epochs: int = 0, on_setup_done: Optional[Callable] = None
        ) -> Window:
    """Run the learner: ``setup_epochs`` epochs of set-up, then whole
    replayed epochs for ``seconds`` (the window), then with
    ``trace_epochs`` that many more under torch.profiler. The window
    starts and ends on a synchronised device."""
    win = Window()
    st: dict = {"phase": "setup"}

    def n_batches() -> int:
        return sum(len(v) for c in learner._caches.values()
                   for v in c.entries.values())

    def start_window():
        sync(device)
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        st["h0"] = _hist(learner, "train_step_seconds")
        st["t0"] = time.perf_counter()
        st["phase"] = "window"

    def close_window():
        sync(device)
        win.seconds = time.perf_counter() - st["t0"]
        s1, n1 = _hist(learner, "train_step_seconds")
        win.dispatch_s, win.dispatch_n = s1 - st["h0"][0], n1 - st["h0"][1]

    def cb(k, train_prog, _val):
        if st["phase"] == "setup":
            if k + 1 < setup_epochs:
                return
            if on_setup_done is not None:
                on_setup_done()
            start_window()
            return
        steps = n_batches()
        if st["phase"] == "window":
            win.epochs += 1
            win.rows += int(train_prog.nrows)
            win.steps += steps
            if not np.isfinite(train_prog.loss):
                win.failed_steps += steps
            if time.perf_counter() - st["t0"] < seconds:
                return
            close_window()
            if trace_epochs <= 0:
                raise WindowClosed
            st["phase"] = "trace"
            st["traced"] = 0
            st["tracer"] = Tracer(learner, device).start()
            return
        st["traced"] += 1
        if st["traced"] >= trace_epochs:
            st["tracer"].stop(st["traced"], steps * st["traced"])
            raise WindowClosed

    learner.add_epoch_end_callback(cb)
    # the learner's progress rows go to stderr: the result is the last
    # line of stdout
    with contextlib.redirect_stdout(sys.stderr):
        try:
            learner.run()
        except WindowClosed:
            pass
        finally:
            learner.epoch_end_callbacks.remove(cb)
            learner.stop()
            tracer = st.get("tracer")
            if tracer is not None:
                tracer.close()
    if st["phase"] == "setup":
        raise RuntimeError("the learner stopped before the window")
    if device.startswith("cuda"):
        win.peak_bytes = int(torch.cuda.max_memory_allocated())
    if "tracer" in st:
        win.traced = st["tracer"].result
    return win


class Tracer:
    """torch.profiler over whole replayed epochs, with the spans on."""

    def __init__(self, learner, device: str):
        self.learner = learner
        self.device = device
        self.result: Optional[dict] = None
        self._stack = contextlib.ExitStack()
        self._prof = None
        self._counts: Dict[str, list] = {
            "gather_real": [], "push_real": [], "push_vm": []}

    def start(self) -> "Tracer":
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self._stack.enter_context(spans(self.learner, self._counts))
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._win = record_function(SPAN_WINDOW)
        self._win.__enter__()
        self._t0 = time.perf_counter()
        return self

    def stop(self, epochs: int, steps: int) -> None:
        sync(self.device)
        wall = time.perf_counter() - self._t0
        self._win.__exit__(None, None, None)
        self._stack.close()
        from .traceread import read_events
        self.result = {"epochs": epochs, "steps": steps, "wall_s": wall,
                       "events": read_events(self._prof),
                       "calls": {k: [int(x) for x in v]
                                 for k, v in self._counts.items()}}

    def close(self) -> None:
        self._stack.close()


def release(learner) -> None:
    """Free the program's device state before the reference runs."""
    learner.store = None
    learner._caches.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
