"""Non-blocking ``selectors`` event-loop frontend: sockets cost file
descriptors, not threads.

A ``socketserver.ThreadingTCPServer`` frontend would park
one OS thread per connection on a batcher future.  Fine
for a runbook; at 10k+ concurrent sockets the
per-thread stacks and scheduler churn are the bottleneck long before
the scorers are.  This module replaces it with the classic event-loop
shape:

- **One acceptor + a few I/O shards.**  ``serve.frontend.threads``
  selector loops (default 2) each own a subset of connections; the
  listening socket lives on shard 0 and new connections are handed out
  round-robin.  Every socket is non-blocking; a shard's loop reads,
  parses complete lines, and writes buffered responses — it NEVER
  blocks on a scorer.
- **Callback dispatch.**  A parsed request goes to
  ``PredictionServer.dispatch_line(line, cb)`` (server.py), which
  submits rows to the replica pool and wires the batcher futures'
  done-callbacks to ``cb`` — no thread waits on a future.  Responses
  come back on whatever thread resolved them and are posted to the
  owning shard through its wake pipe.
- **Per-connection ordering.**  The wire protocol promises responses in
  request order per connection; each request takes a sequence slot and
  completed responses are flushed only when contiguous.
- **Bounded buffers.**  Read buffers are bounded by
  ``serve.max.line.bytes`` exactly like the threaded loop was (an
  oversized line is skimmed to its newline and answered with a
  structured error; binary garbage decodes with replacement; no request
  failure closes the socket).  A client pipelining more than
  ``serve.frontend.pipeline.max`` unanswered requests (or not reading
  its responses) has its reads paused until the backlog drains —
  backpressure instead of unbounded response queues.
- **Graceful drain.**  ``begin_drain`` closes the listener and stops
  reading new requests; in-flight requests keep resolving and their
  responses flush before sockets close.  ``await_drained`` bounds the
  wait (``serve.drain.timeout.sec``) and ``fail_pending`` converts
  whatever is left into structured drain-timeout errors so no client
  ever hangs on a half-shut server.

Config surface (serve.properties; README "Online serving"):

- ``serve.frontend.threads``       — I/O event-loop shards (default 2).
- ``serve.frontend.backlog``       — listen(2) backlog (default 2048).
- ``serve.frontend.pipeline.max``  — per-connection unanswered-request
  cap before reads pause (default 256).
"""

from __future__ import annotations

import json
import selectors
import socket
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from ..core import sanitizer

KEY_IO_THREADS = "serve.frontend.threads"
KEY_BACKLOG = "serve.frontend.backlog"
KEY_PIPELINE_MAX = "serve.frontend.pipeline.max"

DEFAULT_IO_THREADS = 2
DEFAULT_BACKLOG = 2048
DEFAULT_PIPELINE_MAX = 256


def render_response(resp) -> bytes:
    """A dispatch result as wire bytes: dicts as one JSON line, the
    ``{"_text": ...}`` escape as raw text (the ``metrics`` Prometheus
    exposition, ``# EOF``-terminated by its producer)."""
    if isinstance(resp, dict) and "_text" in resp:
        text = resp["_text"]
        if not text.endswith("\n"):
            text += "\n"
        return text.encode()
    return (json.dumps(resp) + "\n").encode()


class _Conn:
    """One client socket's event-loop state (owned by ONE shard; only
    that shard's loop thread touches the buffers)."""

    __slots__ = ("sock", "cid", "rbuf", "wbuf", "seq_next", "send_next",
                 "ready", "inflight", "skimming", "closed", "paused",
                 "want_write", "eof", "meta")

    _next_cid = [0]
    _cid_lock = threading.Lock()

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # completions address connections by a UNIQUE id, never the fd:
        # the OS recycles fds, and a late batcher callback keyed by fd
        # could inject its response into a different client's stream
        with _Conn._cid_lock:
            _Conn._next_cid[0] += 1
            self.cid = _Conn._next_cid[0]
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.seq_next = 0        # next request sequence slot to assign
        self.send_next = 0       # next slot whose response may be sent
        self.ready: Dict[int, bytes] = {}   # out-of-order completions
        self.inflight = 0        # assigned slots not yet completed
        self.skimming = False    # discarding an oversized line
        self.closed = False
        self.paused = False      # reads unregistered (backpressure)
        self.want_write = False
        self.eof = False         # client half-closed; finish then close
        # seq slot -> the request's client-supplied request_id (returned
        # synchronously by dispatch_line): drain-timeout fillers for
        # slots whose callback never fires still echo the client's
        # identity.  Bounded by the pipeline cap; popped on flush.
        self.meta: Dict[int, object] = {}

    def idle(self) -> bool:
        return self.inflight == 0 and not self.wbuf and not self.ready


class _Shard(threading.Thread):
    """One selector loop: a subset of connections (+ the listener on
    shard 0).  Cross-thread work arrives via ``post`` + a wake pipe."""

    def __init__(self, frontend: "EventLoopFrontend", index: int):
        super().__init__(name=f"serve-io-{index}", daemon=True)
        self.frontend = frontend
        self.index = index
        self.sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_lock = sanitizer.make_lock("serve.frontend.wake")
        self._woken = False
        self.sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._posted: deque = deque()
        self._conns: Dict[int, _Conn] = {}
        self.draining = False
        self._stopping = False
        self.drained = threading.Event()

    # -- cross-thread entry -------------------------------------------------
    def post(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on this shard's loop thread (thread-safe)."""
        self._posted.append(fn)
        self._wake()

    def _wake(self) -> None:
        with self._wake_lock:
            if self._woken:
                return
            self._woken = True
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- loop ---------------------------------------------------------------
    def run(self) -> None:
        while True:
            try:
                events = self.sel.select(timeout=0.25)
            except OSError:
                break
            for key, mask in events:
                if key.data == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                    with self._wake_lock:
                        self._woken = False
                elif key.data == "listen":
                    self._accept(key.fileobj)
                else:
                    conn = key.data
                    if mask & selectors.EVENT_READ:
                        self._on_read(conn)
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._on_write(conn)
            while self._posted:
                try:
                    self._posted.popleft()()
                except Exception:               # noqa: BLE001
                    pass                        # a completion for a dead conn
            if self.draining and all(c.idle() for c in self._conns.values()):
                self.drained.set()
            if self._stopping:
                break
        for conn in list(self._conns.values()):
            self._close(conn)
        try:
            self.sel.unregister(self._wake_r)
        except (KeyError, OSError, ValueError):
            pass
        self._wake_r.close()
        self._wake_w.close()
        self.sel.close()

    # -- accept -------------------------------------------------------------
    def _accept(self, listener) -> None:
        for _ in range(64):                     # accept in bursts
            try:
                sock, _addr = listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            self.frontend.assign(sock)

    def adopt(self, sock: socket.socket) -> None:
        """Take ownership of an accepted socket (posted to this shard)."""
        if self.draining or self._stopping:
            sock.close()
            return
        conn = _Conn(sock)
        self._conns[conn.cid] = conn
        try:
            self.sel.register(sock, selectors.EVENT_READ, conn)
        except (OSError, ValueError):
            self._close(conn)

    # -- read side ----------------------------------------------------------
    def _on_read(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            # client half-closed: answer what is already in flight, then
            # close once the write buffer flushes
            conn.eof = True
            self._pause_reads(conn)
            if conn.idle():
                self._close(conn)
            return
        conn.rbuf += data
        self._parse(conn)

    def _parse(self, conn: _Conn) -> None:
        limit = self.frontend.max_line_bytes
        while not conn.closed:
            nl = conn.rbuf.find(b"\n")
            if nl < 0:
                if conn.skimming:
                    conn.rbuf.clear()
                elif len(conn.rbuf) > limit:
                    # oversized line still streaming in: discard until
                    # its newline, then answer a structured error in
                    # this request's ordered slot
                    conn.skimming = True
                    conn.rbuf.clear()
                return
            line = bytes(conn.rbuf[:nl])
            del conn.rbuf[:nl + 1]
            if conn.skimming:
                conn.skimming = False
                self._dispatch_error(conn, limit)
            elif len(line) > limit:
                # the whole oversized line arrived in one buffer
                self._dispatch_error(conn, limit)
            else:
                text = line.decode("utf-8", errors="replace").strip()
                if not text:
                    continue
                seq = conn.seq_next
                conn.seq_next += 1
                conn.inflight += 1
                cid = conn.cid
                meta = self.frontend.server.dispatch_line(
                    text, lambda resp, cid=cid, seq=seq: self.complete(
                        cid, seq, resp), conn=cid)
                if meta is not None and meta.get("request_id") is not None:
                    conn.meta[seq] = meta["request_id"]
            # the pipeline cap applies to EVERY slot-allocating branch —
            # oversized-line errors parked behind a pending response
            # must pause reads too, or conn.ready grows unbounded
            if conn.inflight >= self.frontend.pipeline_max:
                self._pause_reads(conn)
                return

    def _dispatch_error(self, conn: _Conn, limit: int) -> None:
        seq = conn.seq_next
        conn.seq_next += 1
        conn.inflight += 1
        self._apply(conn, seq, render_response(
            {"error": f"request line exceeds serve.max.line.bytes "
                      f"({limit})"}))

    def _pause_reads(self, conn: _Conn) -> None:
        if conn.paused or conn.closed:
            return
        conn.paused = True
        self._reregister(conn)

    def _resume_reads(self, conn: _Conn) -> None:
        if (not conn.paused or conn.closed or conn.eof
                or self.draining):
            return
        conn.paused = False
        self._reregister(conn)
        if conn.rbuf:
            self._parse(conn)

    # -- write side ---------------------------------------------------------
    def complete(self, cid: int, seq: int, resp) -> None:
        """Thread-safe: a request's response is ready (called from
        batcher workers / the command executor / the loop itself)."""
        payload = render_response(resp)
        self.post(lambda: self._apply_completion(cid, seq, payload))

    def _apply_completion(self, cid: int, seq: int, payload: bytes) -> None:
        conn = self._conns.get(cid)
        if conn is None or conn.closed:
            return
        self._apply(conn, seq, payload)

    def _apply(self, conn: _Conn, seq: int, payload: bytes) -> None:
        if seq < conn.send_next:
            return          # already answered (drain-timeout filler won)
        conn.ready[seq] = payload
        flushed = False
        while conn.send_next in conn.ready:
            conn.wbuf += conn.ready.pop(conn.send_next)
            conn.meta.pop(conn.send_next, None)
            conn.send_next += 1
            conn.inflight -= 1
            flushed = True
        if flushed and conn.inflight < max(1, self.frontend.pipeline_max // 2):
            self._resume_reads(conn)
        if conn.wbuf:
            self._on_write(conn)            # opportunistic immediate send
        elif conn.idle() and (conn.eof or self.draining):
            self._close(conn)

    def _on_write(self, conn: _Conn) -> None:
        try:
            while conn.wbuf:
                n = conn.sock.send(conn.wbuf)
                if n <= 0:
                    break
                del conn.wbuf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        want = bool(conn.wbuf)
        if want != conn.want_write:
            conn.want_write = want
            self._reregister(conn)
        if conn.idle() and (conn.eof or self.draining):
            self._close(conn)

    def _reregister(self, conn: _Conn) -> None:
        """Sync the selector mask with (paused, want_write).  A mask of
        zero is invalid for selectors, so a fully-quiet socket (reads
        paused, nothing to write) is unregistered; the next completion
        or resume re-registers it."""
        mask = 0
        if not conn.paused:
            mask |= selectors.EVENT_READ
        if conn.want_write:
            mask |= selectors.EVENT_WRITE
        try:
            if mask:
                try:
                    self.sel.modify(conn.sock, mask, conn)
                except KeyError:
                    self.sel.register(conn.sock, mask, conn)
            else:
                try:
                    self.sel.unregister(conn.sock)
                except KeyError:
                    pass
        except (ValueError, OSError):
            self._close(conn)

    def _close(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        self._conns.pop(conn.cid, None)
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- drain / stop (posted from the frontend) ----------------------------
    def begin_drain(self) -> None:
        self.draining = True
        for conn in self._conns.values():
            self._pause_reads(conn)
        if all(c.idle() for c in self._conns.values()):
            self.drained.set()

    def fail_pending(self, message: str) -> None:
        for conn in list(self._conns.values()):
            while conn.send_next + len(conn.ready) < conn.seq_next:
                # fill the earliest missing slot with the drain error —
                # echoing the slot's request_id (captured at dispatch)
                # so even an abandoned request stays correlatable
                seq = conn.send_next
                while seq in conn.ready:
                    seq += 1
                err = {"error": message, "timeout": True}
                rid = conn.meta.get(seq)
                if rid is not None:
                    err["request_id"] = rid
                self._apply(conn, seq, render_response(err))

    def stop(self) -> None:
        self._stopping = True


class EventLoopFrontend:
    """The TCP acceptor + I/O shard set a :class:`PredictionServer`
    owns.  ``server`` must expose ``dispatch_line(line, cb)`` and
    ``max_line_bytes``."""

    def __init__(self, server, host: str, port: int,
                 io_threads: int = DEFAULT_IO_THREADS,
                 backlog: int = DEFAULT_BACKLOG,
                 pipeline_max: int = DEFAULT_PIPELINE_MAX):
        self.server = server
        self.max_line_bytes = server.max_line_bytes
        self.pipeline_max = max(1, int(pipeline_max))
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(int(backlog))
        self._listener.setblocking(False)
        self.port = self._listener.getsockname()[1]
        self._rr = 0
        self._draining = False
        self.shards: List[_Shard] = [
            _Shard(self, i) for i in range(max(1, int(io_threads)))]
        self.shards[0].sel.register(
            self._listener, selectors.EVENT_READ, "listen")
        for s in self.shards:
            s.start()

    def assign(self, sock: socket.socket) -> None:
        """Round-robin an accepted socket onto a shard (called on shard
        0's loop from the acceptor)."""
        shard = self.shards[self._rr % len(self.shards)]
        self._rr += 1
        if shard is self.shards[0]:
            shard.adopt(sock)
        else:
            shard.post(lambda: shard.adopt(sock))
            shard._wake()

    def connections(self) -> int:
        return sum(len(s._conns) for s in self.shards)

    # -- drain / stop -------------------------------------------------------
    def begin_drain(self) -> None:
        """Stop accepting and stop reading new requests; in-flight
        requests keep resolving and their responses still flush."""
        if self._draining:
            return
        self._draining = True

        def close_listener():
            try:
                self.shards[0].sel.unregister(self._listener)
            except (KeyError, ValueError, OSError):
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        self.shards[0].post(close_listener)
        for s in self.shards:
            s.post(s.begin_drain)

    def await_drained(self, timeout: float) -> bool:
        """True when every shard flushed every pending response within
        ``timeout`` seconds."""
        import time as _time
        end = _time.monotonic() + max(0.0, timeout)
        ok = True
        for s in self.shards:
            remaining = end - _time.monotonic()
            if remaining <= 0 or not s.drained.wait(remaining):
                ok = False
        return ok

    def fail_pending(self, message: str) -> None:
        """Convert still-unanswered requests into structured errors (the
        drain deadline passed; no client hangs on a half-shut server)."""
        for s in self.shards:
            s.post(lambda s=s: s.fail_pending(message))

    def stop(self) -> None:
        if not self._draining:
            try:
                self._listener.close()
            except OSError:
                pass
        for s in self.shards:
            s.stop()
            s._wake()
        for s in self.shards:
            s.join(timeout=10)
