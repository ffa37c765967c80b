"""The open-loop load generator: one process of the benchmark's own,
standard library only (no torch, nothing of the program).

    python3 client.py <spec.json>

The spec names the server (``host``, ``port``), the number of persistent
connections (``conns``), the files of intended send offsets (seconds
from the window's start, one a line) and of pre-rendered request lines
(one JSON object a line, in the same order), the window (``seconds``),
how long to wait for the last answers after it (``drain_s``) and where
to write the results (``out_path``).

Each connection carries one request at a time.  A request is sent when
it is due; one that finds no free connection waits for the next free
one and is late, and its latency still counts from when it was due.
After connecting, the client prints ``ready`` and waits for ``go`` on
its standard input; the window starts then.  It writes, per request, the
send and receive times (seconds from the window's start; null where
none) and the response line, then prints ``done``.
"""

from __future__ import annotations

import collections
import json
import selectors
import socket
import sys
import time


def run(spec: dict) -> dict:
    with open(spec["offsets_path"]) as fh:
        offsets = [float(v) for v in fh.read().split()]
    with open(spec["requests_path"], "rb") as fh:
        requests = fh.read().split(b"\n")[:len(offsets)]
    n = len(offsets)
    socks = []
    sel = selectors.DefaultSelector()
    for c in range(int(spec["conns"])):
        s = socket.create_connection((spec["host"], int(spec["port"])),
                                     timeout=30)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        socks.append(s)
        sel.register(s, selectors.EVENT_READ, c)
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        raise SystemExit("client: expected go")

    sent = [None] * n
    recv = [None] * n
    resp = [None] * n
    free = collections.deque(range(len(socks)))
    inflight = {}                      # connection -> request index
    bufs = [b""] * len(socks)
    pending = collections.deque()      # due, not yet sent
    nxt = 0
    t0 = time.perf_counter()
    deadline = float(spec["seconds"]) + float(spec["drain_s"])
    clock = time.perf_counter
    while True:
        now = clock() - t0
        while nxt < n and offsets[nxt] <= now:
            pending.append(nxt)
            nxt += 1
        while pending and free:
            c = free.popleft()
            k = pending.popleft()
            socks[c].sendall(requests[k] + b"\n")
            sent[k] = clock() - t0
            inflight[c] = k
        if nxt >= n and not pending and not inflight:
            break
        if now > deadline:
            break
        wait = 0.05
        if nxt < n and free:
            wait = max(0.0, min(wait, offsets[nxt] - (clock() - t0)))
        for key, _ in sel.select(timeout=wait):
            c = key.data
            data = socks[c].recv(1 << 16)
            if not data:
                raise SystemExit("client: the server closed a connection")
            bufs[c] += data
            while b"\n" in bufs[c]:
                line, bufs[c] = bufs[c].split(b"\n", 1)
                k = inflight.pop(c, None)
                if k is None:
                    continue
                recv[k] = clock() - t0
                resp[k] = line.decode("utf-8", "replace")
                free.append(c)
    for s in socks:
        s.close()
    return {"t0_perf": t0, "sent": sent, "recv": recv, "responses": resp,
            "unsent": n - sum(1 for v in sent if v is not None)}


def main() -> int:
    with open(sys.argv[1]) as fh:
        spec = json.load(fh)
    out = run(spec)
    with open(spec["out_path"], "w") as fh:
        json.dump(out, fh)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
