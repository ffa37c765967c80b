"""Replay an eager chain of CUDA launches as one CUDA graph.

The serving paths that emulate XLA's float math op by op (the NB
scorers, the stream tier's decide) launch tens to thousands of small
kernels a call, and each launch takes and gives back the interpreter
lock: under a server's concurrent threads the launches, not the card,
set the latency.  :class:`GraphedCall` captures such a function once per
argument signature into a CUDA graph and replays it: the same kernels
with the same arguments, so the same bits, in one launch.
"""

from __future__ import annotations

import threading

import torch


def _to_host(out):
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    return out


class GraphedCall:
    """``fn`` (tensors in, a tensor or a tuple of tensors and ``None`` out)
    as one CUDA graph per signature of its arguments (shapes, dtypes and
    keyword values).

    The first call at a signature runs ``fn`` once eagerly on a side
    stream (which builds any per-device constant tables it caches) and
    captures it over static copies of the arguments on the card; every
    call copies its arguments (on the card or on the host) into those
    buffers, replays the graph and returns the outputs copied to the
    host.  Calls of one signature share their buffers, so a call holds
    the lock from the copy to the read-back.  ``fn`` must not read a
    device value on the host (a graph cannot)."""

    def __init__(self, fn, device):
        self._fn = fn
        self._device = torch.device(device)
        self._graphs: dict = {}
        self._lock = threading.Lock()

    def _capture(self, args, kw):
        dev = self._device
        static = [torch.empty_like(a, device=dev).copy_(a) for a in args]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fn(*static, **kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # other threads keep using the card while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._fn(*static, **kw)
        return graph, static, out

    def __call__(self, *args, **kw):
        key = (tuple((tuple(a.shape), a.dtype) for a in args),
               tuple(sorted(kw.items())))
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(args, kw)
            graph, static, out = entry
            for buf, a in zip(static, args):
                buf.copy_(a)
            graph.replay()
            return _to_host(out)
