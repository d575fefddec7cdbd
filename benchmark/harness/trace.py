"""Host spans and the device trace, in plain records that the metric
readers take.

Host spans are ``torch.profiler.record_function`` ranges named
``bench.<layer>``, opened by the benchmark's own wrappers around public
calls into each layer. ``device_record`` turns a ``torch.profiler`` profile
into:

``window``
    (start, end) seconds of the traced stretch (its ``bench.traced`` span);
``device``
    one row a device operation (kernel, copy or fill): (name, start, end,
    op, span, launch): the outermost aten operation that launched it, the
    innermost ``bench.`` span around that launch, and the launch's host
    time;
``spans``
    (name, start, end) of every ``bench.`` span on the host.

Times are seconds on the profiler's clock.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType

SPAN = "bench."
TRACED = "bench.traced"


class Span:
    """A ``bench.<name>`` host span, opened and closed by hand (as module
    hooks need); a no-op outside a profile except for its cost, a
    microsecond or two."""

    def __init__(self, name: str):
        self.rf = torch.profiler.record_function(SPAN + name)

    def open(self):
        self.rf.__enter__()
        return self

    def close(self):
        self.rf.__exit__(None, None, None)


class OpCapture:
    """A context in which every call of the operators named in ``keep``
    (``namespace::name``) on ``device`` tensors passes first through a
    Python kernel registered for that device's dispatch key, which appends
    ``keep[name](*args)`` to ``calls[name]``, then runs the operator's own
    kernel (``torch.library.get_kernel``). Only those operators reach
    Python: a microsecond or so a call, nothing launched on the device for
    it. Leaving the context removes the Python kernels."""

    def __init__(self, keep: Dict[str, Callable], device: str = "cuda"):
        self.keep = keep
        self.key = {"cuda": "CUDA", "cpu": "CPU"}[device]
        self.calls: Dict[str, List[tuple]] = {n: [] for n in keep}
        self.lib = None

    def __enter__(self):
        self.lib = torch.library.Library(next(iter(self.keep)).split(
            "::")[0], "IMPL")
        for name, keep in self.keep.items():
            ns, op = name.split("::")
            own = torch.library.get_kernel(name, self.key)
            kept = self.calls[name]

            def kernel(keyset, *args, own=own, keep=keep, kept=kept):
                kept.append(keep(*args))
                return own.call_boxed(keyset, *args)
            self.lib.impl(op, kernel, self.key, with_keyset=True)
        return self

    def __exit__(self, *exc):
        self.lib._destroy()
        self.lib = None


def _nest(rows):
    """Parent index of each CPU row (start, end, name, thread, ...) by time
    nesting on its thread, or -1."""
    parent = [-1] * len(rows)
    by_thread: Dict[int, List[int]] = {}
    for i, r in enumerate(rows):
        by_thread.setdefault(r[3], []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (rows[i][0], -rows[i][1]))
        stack: List[int] = []
        for i in idx:
            while stack and rows[stack[-1]][1] <= rows[i][0]:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
    return parent


def device_record(prof) -> Dict[str, List[Tuple]]:
    """The record (module note) of a finished ``torch.profiler`` profile,
    from its raw events: a device operation is tied to the CPU operation
    that launched it by the profiler's correlation ids, and that operation
    to its outermost enclosing operation and ``bench.`` span by time
    nesting on its thread. The profiler's own device-side copies of the
    ``bench.`` annotations are not device operations."""
    cpu, dev = [], []
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    for e in events:
        name = e.name()
        s = (e.start_ns() - base) / 1e9
        t = s + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CPU:
            cpu.append((s, t, name, e.start_thread_id(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN) or (
                    hasattr(e, "is_user_annotation")
                    and e.is_user_annotation()):
                continue
            dev.append((name, s, t, e.correlation_id(),
                        e.linked_correlation_id()))
    parent = _nest(cpu)
    op_by_id, launch_by_id = {}, {}
    for i, r in enumerate(cpu):
        if r[5] == 0:
            op_by_id.setdefault(r[4], i)
        else:                        # a runtime call tied to its kernel
            launch_by_id.setdefault(r[4], i)
    memo: Dict[int, Tuple[str, str]] = {}

    def resolve(i):
        if i in memo:
            return memo[i]
        op, span, node = "none", "none", i
        while node >= 0:
            name = cpu[node][2]
            if name.startswith(SPAN):
                span = name
                break
            if not name.startswith("cuda"):
                op = name
            node = parent[node]
        memo[i] = (op, span)
        return memo[i]
    device = []
    for name, s, t, corr, linked in dev:
        i = op_by_id.get(linked, launch_by_id.get(corr, -1))
        op, span = resolve(i) if i >= 0 else ("none", "none")
        device.append((name, s, t, op, span,
                       cpu[i][0] if i >= 0 else float("nan")))
    spans = [(r[2], r[0], r[1]) for r in cpu if r[2].startswith(SPAN)]
    window = next(((s, t) for name, s, t in spans if name == TRACED), None)
    if window is None and device:
        window = (min(d[1] for d in device), max(d[2] for d in device))
    return {"window": window, "device": device, "spans": spans}


def busy_intervals(device: List[Tuple], window) -> List[Tuple[float, float]]:
    """The union of the device rows' intervals inside ``window``, sorted."""
    lo, hi = window
    ivs = sorted((max(d[1], lo), min(d[2], hi)) for d in device
                 if d[2] > lo and d[1] < hi)
    out: List[Tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(record) -> float:
    return sum(e - s for s, e in busy_intervals(record["device"],
                                                record["window"]))


def idle_gaps(record) -> List[Tuple[float, float]]:
    """The gaps of the window in which no device operation ran."""
    lo, hi = record["window"]
    gaps, at = [], lo
    for s, e in busy_intervals(record["device"], record["window"]):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def span_at(record, t: float) -> str:
    """The innermost (latest opened) ``bench.`` span covering host time
    ``t``, other than the whole traced stretch."""
    best = None
    for name, s, e in record["spans"]:
        if name != TRACED and s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0][len(SPAN):] if best else "none"


def breakdown(record, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, grouped by the aten
    operation that launched them, and the idle seconds by the host span
    they fell in: ``top`` of each, largest first."""
    by_op: Dict[str, float] = {}
    lo, hi = record["window"]
    for name, s, e, op, _, _ in record["device"]:
        if e > lo and s < hi:
            by_op[op] = by_op.get(op, 0.0) + min(e, hi) - max(s, lo)
    by_span: Dict[str, float] = {}
    for s, e in idle_gaps(record):
        k = span_at(record, (s + e) / 2)
        by_span[k] = by_span.get(k, 0.0) + e - s
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_span)}
