"""Persistent pooled backend links: the router's data plane.

One :class:`BackendLink` per configured backend serving process
(``router.backends=host:port,host:port``), each holding a small pool of
persistent pipelined connections (``router.backend.connections``).  A
connection is the classic FIFO-pipelining shape the wire protocol
guarantees (responses in request order per connection): the sender
appends the completion callback and writes the request line under ONE
lock, a dedicated reader thread pops callbacks as response lines
arrive.  No thread ever parks on an individual request.

Failure semantics are the whole point: when a backend dies (EOF, reset,
send failure), every in-flight callback on the lost connection fires
with ``None`` — the router's retry-on-sibling path turns that into a
re-dispatch for idempotent scoring requests and a structured
``backend_lost`` error for everything else.  Dead connection slots
reconnect lazily on the next send with a short holdoff, so a restarted
backend re-admits without anyone orchestrating it.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from ...core import sanitizer

KEY_BACKENDS = "router.backends"
KEY_CONNECTIONS = "router.backend.connections"
KEY_REQUEST_TIMEOUT = "router.request.timeout.sec"

DEFAULT_CONNECTIONS = 2
DEFAULT_REQUEST_TIMEOUT = 30.0

#: seconds before a failed connect is retried (lazy, per link)
RECONNECT_HOLDOFF_SEC = 0.5
CONNECT_TIMEOUT_SEC = 5.0


def parse_backends(raw: Optional[str]) -> List[Tuple[str, int]]:
    """``host:port,host:port`` -> [(host, port)].  Bare ports default to
    loopback (the single-host pod shape of the runbooks)."""
    out: List[Tuple[str, int]] = []
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, port = part.rsplit(":", 1)
        else:
            host, port = "127.0.0.1", part
        out.append((host.strip() or "127.0.0.1", int(port)))
    return out


class _BackendConn(threading.Thread):
    """One persistent pipelined connection: FIFO callbacks + a reader."""

    def __init__(self, link: "BackendLink", index: int,
                 sock: socket.socket):
        super().__init__(name=f"avenir-fleet-read-{link.name}-{index}",
                         daemon=True)
        self.link = link
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._lock = sanitizer.make_lock("fleet.backend.conn")
        self._pending: deque = deque()
        self.dead = False
        self._failed = False

    def inflight(self) -> int:
        with self._lock:
            return len(self._pending)

    def send(self, payload: bytes,
             cb: Callable[[Optional[bytes]], None]) -> bool:
        """Append the callback and write the line ATOMICALLY (the FIFO
        order on the deque must match the order on the wire).  Returns
        False without invoking ``cb`` when the connection is (or just
        became) unusable."""
        with self._lock:
            if self.dead:
                return False
            self._pending.append(cb)
            try:
                self._sock.sendall(payload)
                return True
            except OSError:
                self._pending.pop()
                self.dead = True
        self._fail()
        return False

    def run(self) -> None:
        try:
            for raw in self._rfile:
                with self._lock:
                    cb = self._pending.popleft() if self._pending else None
                if cb is None:
                    continue        # unsolicited line: protocol violation
                try:
                    cb(raw)
                except Exception:                       # noqa: BLE001
                    pass            # a completion for a dead client conn
        except (OSError, ValueError):
            pass
        finally:
            self._fail()

    def _fail(self) -> None:
        """Fail every still-pending callback with ``None`` exactly once
        (reader EOF and a send error can race here)."""
        with self._lock:
            if self._failed:
                return
            self._failed = True
            self.dead = True
            orphans = list(self._pending)
            self._pending.clear()
        try:
            self._sock.close()
        except OSError:
            pass
        for cb in orphans:
            try:
                cb(None)
            except Exception:                           # noqa: BLE001
                pass

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._fail()


class BackendLink:
    """One backend's connection pool + in-flight accounting."""

    def __init__(self, host: str, port: int,
                 n_conns: int = DEFAULT_CONNECTIONS):
        self.host = host
        self.port = int(port)
        self.name = f"{host}:{port}"
        self.n_conns = max(1, int(n_conns))
        self._lock = sanitizer.make_lock("fleet.backend.link")
        self._conns: List[Optional[_BackendConn]] = [None] * self.n_conns
        self._retry_at = 0.0
        self.forwarded = 0
        self.lost = 0

    def _connect_slot(self, index: int) -> _BackendConn:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=CONNECT_TIMEOUT_SEC)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        sock.settimeout(None)
        conn = _BackendConn(self, index, sock)
        conn.start()
        return conn

    def alive(self) -> bool:
        """True when at least one pooled connection is currently live
        (no reconnect attempt — the dispatch ladder's cheap check)."""
        with self._lock:
            return any(c is not None and not c.dead for c in self._conns)

    def inflight(self) -> int:
        with self._lock:
            conns = [c for c in self._conns if c is not None]
        return sum(c.inflight() for c in conns if not c.dead)

    def _conn(self) -> Optional[_BackendConn]:
        """The least-loaded live connection, lazily reconnecting dead
        slots (holdoff-gated so a dead backend costs one connect attempt
        per holdoff, not one per request)."""
        with self._lock:
            best = None
            for i, c in enumerate(self._conns):
                if c is None or c.dead:
                    now = time.monotonic()
                    if now < self._retry_at:
                        continue
                    try:
                        c = self._conns[i] = self._connect_slot(i)
                    except OSError:
                        self._retry_at = now + RECONNECT_HOLDOFF_SEC
                        continue
                if best is None or c.inflight() < best.inflight():
                    best = c
            return best

    def send(self, payload: bytes,
             cb: Callable[[Optional[bytes]], None]) -> bool:
        """Forward one request line; ``cb`` fires with the raw response
        line, or ``None`` if the connection is lost first.  Returns
        False (``cb`` NOT invoked) when no connection can carry it."""
        for _ in range(self.n_conns + 1):
            c = self._conn()
            if c is None:
                return False
            if c.send(payload, cb):
                with self._lock:
                    self.forwarded += 1
                return True
        return False

    def command(self, obj: dict, timeout: float) -> Optional[dict]:
        """Synchronous control-plane request (the control loop and the
        router's stats/health fan-out); None on loss or timeout."""
        done = threading.Event()
        box: List[Optional[bytes]] = []

        def cb(raw: Optional[bytes]) -> None:
            box.append(raw)
            done.set()

        if not self.send((json.dumps(obj) + "\n").encode(), cb):
            return None
        if not done.wait(timeout) or not box or box[0] is None:
            return None
        try:
            out = json.loads(box[0].decode())
        except ValueError:
            return None
        return out if isinstance(out, dict) else None

    def note_lost(self) -> None:
        with self._lock:
            self.lost += 1

    def section(self) -> dict:
        with self._lock:
            conns = [c for c in self._conns if c is not None]
            forwarded, lost = self.forwarded, self.lost
        return {"alive": any(not c.dead for c in conns),
                "connections": sum(1 for c in conns if not c.dead),
                "inflight": sum(c.inflight() for c in conns
                                if not c.dead),
                "forwarded": forwarded, "lost": lost}

    def close(self) -> None:
        with self._lock:
            conns = [c for c in self._conns if c is not None]
            self._conns = [None] * self.n_conns
        for c in conns:
            c.close()
        for c in conns:
            c.join(timeout=5)
