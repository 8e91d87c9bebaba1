"""Kernel times on the card: device-only, per call, and from the profiler.

Three ways to time ``fn(*args)`` over a list of input copies. The calls
cycle through the copies, and the last ``len(args_list)`` results are
kept alive, so that each launch reads inputs and writes an output that
the 50 MB L2 does not hold, as the main path meets them (a densified
slab stays resident; a freed output would be handed straight back by
the caching allocator and written while L2 still holds it).

- ``graph_ms``: device time alone. The calls are captured in a
  ``torch.cuda.CUDAGraph`` and the graph is replayed between CUDA
  events, after as many untimed replays; the time is the mean per
  launch, the least over three captures (on the card, one capture in a
  few read some µs a launch above the kernel's own time, which
  ``torch.profiler`` showed unchanged). No host work falls inside the
  window, so this is the kernel's time (with a memset, where a design
  has one) and nothing of the wrapper's. The wrappers launch on
  ``torch.cuda.current_stream()``, which is the capture stream during
  capture; a wrapper that cannot be captured raises here.
- ``events_ms``: what a caller pays per call: CUDA events around a loop
  of wrapper calls, so the window holds whichever is slower, the device
  or the host enqueueing the next launch. ``call − device`` is the
  wrapper's host cost.
- ``profiler_ms``: ``torch.profiler`` device time per call, summed over
  every device activity of the calls (kernels and memsets), by name.

Nothing here runs without a card, and nothing at import.
"""

from __future__ import annotations

import math
from collections import deque

WINDOW_MS = 10.0  # least device time a timed window (and its warm-up) holds


def _calls(fn, args_list: list, n: int, keep: deque) -> None:
    for i in range(n):
        keep.append(fn(*args_list[i % len(args_list)]))


def events_ms(fn, args_list: list, iters: int, warmup: int = 3) -> float:
    """Mean time per call of ``fn(*args)`` from CUDA events over
    ``iters`` calls cycling through ``args_list``."""
    import torch
    keep: deque = deque(maxlen=len(args_list))
    _calls(fn, args_list, max(warmup, len(args_list)), keep)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _calls(fn, args_list, iters, keep)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _replays_ms(graph, n: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def graph_ms(fn, args_list: list, launches: int = 20,
             replays: int = 5, captures: int = 3) -> float:
    """Mean device time per call of ``fn(*args)``, the least over
    ``captures`` CUDA graphs of ``launches`` calls cycling through
    ``args_list`` (_graph_once)."""
    return min(_graph_once(fn, args_list, launches, replays)
               for _ in range(captures))


def _graph_once(fn, args_list: list, launches: int, replays: int) -> float:
    """One capture, replayed at least ``replays`` times (and for at
    least WINDOW_MS) between CUDA events, after as many untimed
    replays. Every copy is called first (on a side stream, as capture
    wants), so caches the wrappers fill — the expression program's
    device buffer — hold every copy and no host-to-device copy falls
    inside the capture."""
    import torch
    keep: deque = deque(maxlen=len(args_list))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _calls(fn, args_list, max(len(args_list), 2), keep)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _calls(fn, args_list, launches, keep)
    once = _replays_ms(graph, 1)
    n = max(replays, math.ceil(WINDOW_MS / max(once, 1e-3)))
    _replays_ms(graph, n)  # clocks up
    ms = _replays_ms(graph, n) / (n * launches)
    keep.clear()
    del graph
    torch.cuda.synchronize()
    return ms


def profiler_ms(fn, args_list: list, calls: int = 20
                ) -> tuple[float | None, list[str]]:
    """(device ms per call, names of the device activities) from
    ``torch.profiler`` over ``calls`` calls; (None, []) where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    keep: deque = deque(maxlen=len(args_list))
    _calls(fn, args_list, len(args_list), keep)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _calls(fn, args_list, calls, keep)
        torch.cuda.synchronize()
    total_us, names = 0.0, []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            total_us += us
            names.append(evt.key[:80])
    if total_us <= 0:
        return None, []
    return total_us / calls / 1e3, names
