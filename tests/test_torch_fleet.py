"""The fleet router tier in the port (``avenir_tpu_torch/serve/fleet``),
held against the JAX package's (``avenir_tpu/serve/fleet``):

- ``parse_backends`` on the same strings;
- 64 churn rows through the port's router over two port servers on the
  CPU: each response line equals the direct backend's and the reference
  server's on the same NB artifact (the reference's bootstrap bytes);
- least-loaded spread, command fan-out and the fleet-summed stats, each
  the reference router's over the same stub backends;
- retry on a sibling after a backend dies mid-flight, exactly once, and
  a non-idempotent command that is never retried;
- the lease's generations and handoff, and the control loop's autoscale
  decisions over one rate sequence, step for step the reference's;
- the runbook module's rewrites for this tier (sibling directories, the
  argument-list form, no ``--device`` for ``router``/``fleetobs``, the
  ``core`` imports, a job class a script builds itself), and
  ``resource/ci/router_smoke.py`` through the port on the CPU.
"""

import json
import os
import random
import socket
import threading
import time

import pytest

from avenir_tpu.core.config import JobConfig as JaxJobConfig
from avenir_tpu.serve import PredictionServer as JaxServer
from avenir_tpu.serve.fleet import backend as jbackend
from avenir_tpu.serve.fleet.control import ControlLoop as JaxControlLoop
from avenir_tpu.serve.fleet.lease import RouterLease as JaxLease
from avenir_tpu.serve.fleet.router import FleetRouter as JaxRouter
from avenir_tpu.serve.frontend import EventLoopFrontend as JaxFrontend

from avenir_tpu_torch import runbook
from avenir_tpu_torch.core.config import JobConfig, parse_properties
from avenir_tpu_torch.serve import PredictionServer
from avenir_tpu_torch.serve.fleet import (ControlLoop, FleetRouter,
                                          RouterLease, parse_backends)
from avenir_tpu_torch.serve.frontend import EventLoopFrontend
from avenir_tpu_torch.serve.server import request
from avenir_tpu_torch.workload import Scenario
from avenir_tpu_torch.workload.generators import churn_row
from avenir_tpu_torch.workload.runner import _train_artifact

REPO = runbook.REPO


@pytest.mark.parametrize("text", ["h:1, 2,", None, "", "127.0.0.1:8761",
                                  "a:1,b:2,3"])
def test_parse_backends_equals_the_reference(text):
    assert parse_backends(text) == jbackend.parse_backends(text)


# ---------------------------------------------------------------------------
# real servers behind the router
# ---------------------------------------------------------------------------

def _raw(port, payload: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(payload)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return buf


def test_router_responses_equal_direct_and_the_reference_server(tmp_path):
    """Two port servers (``device="cpu"``) behind the port's router; the
    same 64 churn requests sent to a backend directly, through the
    router, and to the reference's server over the same artifact: every
    response line is the same bytes."""
    scn = Scenario(JobConfig(parse_properties(
        "workload.scenario.name=fleet\nworkload.seed=11\n"
        "workload.phases=p\nworkload.phase.p.rate=1\n"
        "workload.phase.p.duration.sec=1\n")))
    schema, model = _train_artifact(scn, str(tmp_path / "boot"),
                                    device="cpu")
    props = {"serve.models": "churn", "serve.model.churn.kind": "naiveBayes",
             "serve.model.churn.feature.schema.file.path": schema,
             "serve.model.churn.bayesian.model.file.path": model,
             "serve.port": "0"}
    backends = [PredictionServer(JobConfig(dict(props)), device="cpu")
                for _ in range(2)]
    ref = JaxServer(JaxJobConfig(dict(props)))
    ports = [b.start() for b in backends]
    ref_port = ref.start()
    router = FleetRouter(JobConfig({
        "router.backends": ",".join(str(p) for p in ports),
        "router.request.timeout.sec": "30"}))
    rfe = EventLoopFrontend(router, "127.0.0.1", 0, io_threads=1)
    router.frontend = rfe
    try:
        rng = random.Random(17)
        for i in range(64):
            payload = (json.dumps({"model": "churn",
                                   "row": churn_row(rng, i),
                                   "request_id": f"rq-{i}"}) + "\n").encode()
            direct = _raw(ports[i % 2], payload)
            routed = _raw(rfe.port, payload)
            theirs = _raw(ref_port, payload)
            assert b'"output"' in direct, direct
            assert routed == direct == theirs, (i, direct, routed, theirs)
        assert router.section()["counters"]["Forwarded"] == 64
    finally:
        rfe.stop()
        router.stop()
        for b in backends:
            b.stop()
        ref.stop()


# ---------------------------------------------------------------------------
# the dispatch policy over stub backends, against the reference router
# ---------------------------------------------------------------------------

class StubBackend:
    """Duck-typed backend behind a real frontend: scores instantly unless
    ``hold`` gates it; records what it answered."""

    max_line_bytes = 1 << 20

    def __init__(self, tag, hold=None):
        self.tag = tag
        self.hold = hold
        self.scored = []
        self.cmds = []
        self._lock = threading.Lock()

    def dispatch_line(self, line, cb, conn=None):
        obj = json.loads(line)
        rid = obj.get("request_id")
        cmd = obj.get("cmd")
        if cmd is not None:
            with self._lock:
                self.cmds.append(obj)
            resp = {"ok": True, "cmd": cmd, "backend": self.tag}
            if cmd == "stats":
                resp = {"models": {"m": {"counters": {
                    "Serve": {"Requests": len(self.scored),
                              "Scorer compilations": 2}}}}}
            if rid is not None:
                resp["request_id"] = rid
            cb(resp)
            return {"request_id": rid} if rid is not None else None

        def reply():
            if self.hold is not None and not self.hold.wait(10):
                return
            with self._lock:
                self.scored.append(obj)
            resp = {"ok": True, "backend": self.tag, "row": obj.get("row")}
            if rid is not None:
                resp["request_id"] = rid
            cb(resp)

        if self.hold is None:
            reply()
        else:
            threading.Thread(target=reply, daemon=True).start()
        return {"request_id": rid} if rid is not None else None


PACKAGES = {"port": (FleetRouter, EventLoopFrontend, JobConfig),
            "jax": (JaxRouter, JaxFrontend, JaxJobConfig)}


def _fleet(pkg, backends, **overrides):
    """A router of package ``pkg`` in front of stub ``backends`` (the
    port's frontends); returns (router, its frontend, backend frontends)."""
    router_cls, fe_cls, cfg_cls = PACKAGES[pkg]
    fes = [EventLoopFrontend(b, "127.0.0.1", 0, io_threads=1)
           for b in backends]
    props = {"router.backends": ",".join(f"127.0.0.1:{f.port}"
                                         for f in fes),
             "router.backend.connections": "1",
             "router.request.timeout.sec": "5"}
    props.update({k: str(v) for k, v in overrides.items()})
    router = router_cls(cfg_cls(props))
    rfe = fe_cls(router, "127.0.0.1", 0, io_threads=1)
    router.frontend = rfe
    return router, rfe, fes


def _close(router, rfe, fes):
    rfe.stop()
    router.stop()
    for f in fes:
        f.stop()


def _spread_and_fanout(pkg):
    b1, b2 = StubBackend("b1"), StubBackend("b2")
    router, rfe, fes = _fleet(pkg, [b1, b2])
    try:
        for i in range(20):
            assert request("127.0.0.1", rfe.port,
                           {"model": "m", "row": str(i)}, timeout=5)["ok"]
        fan = request("127.0.0.1", rfe.port, {"cmd": "reload", "model": "m"},
                      timeout=5)
        stats = request("127.0.0.1", rfe.port, {"cmd": "stats"}, timeout=5)
        return {"scored": (len(b1.scored), len(b2.scored)),
                "forwarded": router.section()["counters"]["Forwarded"],
                "fan_ok": fan["ok"], "fan_backends": len(fan["backends"]),
                "cmds": ([c["cmd"] for c in b1.cmds],
                         [c["cmd"] for c in b2.cmds]),
                "compiles": stats["models"]["m"]["counters"]["Serve"][
                    "Scorer compilations"],
                "stats_backends": len(stats["backends"])}
    finally:
        _close(router, rfe, fes)


def test_least_loaded_spread_and_fanout_equal_the_reference():
    """20 scoring requests (none dropped, the same split), a ``reload``
    fanned out to both backends, and fleet-summed ``stats``: the port's
    router and the reference's give the same account."""
    mine, theirs = _spread_and_fanout("port"), _spread_and_fanout("jax")
    assert mine == theirs
    assert sum(mine["scored"]) == 20 and mine["forwarded"] == 20
    assert mine["fan_backends"] == 2 and mine["compiles"] == 4
    assert mine["cmds"] == (["reload", "stats"], ["reload", "stats"])


def test_backend_killed_midflight_retries_on_sibling_once():
    """Requests in flight on a backend that dies re-dispatch to the
    sibling once each: none dropped, none scored twice."""
    hold = threading.Event()
    b1, b2 = StubBackend("b1", hold=hold), StubBackend("b2")
    router, rfe, fes = _fleet("port", [b1, b2])
    try:
        results, threads = [], []

        def one(i):
            results.append(request(
                "127.0.0.1", rfe.port,
                {"model": "m", "row": f"r{i}", "request_id": f"rq{i}"},
                timeout=10))

        for i in range(6):
            t = threading.Thread(target=one, args=(i,), daemon=True)
            t.start()
            threads.append(t)
        name = f"127.0.0.1:{fes[0].port}"
        deadline = time.monotonic() + 5
        while router.section()["backends"][name]["inflight"] == 0:
            assert time.monotonic() < deadline, "nothing reached b1"
            time.sleep(0.01)
        fes[0].stop()
        for t in threads:
            t.join(timeout=10)
        assert len(results) == 6 and all(r.get("ok") for r in results)
        rows = [o["row"] for o in b1.scored + b2.scored]
        assert sorted(rows) == sorted(set(rows))
        # every lost request went to the sibling once and was answered
        # there; a request whose first send found b1 already closed moved
        # on without a retry and is counted as a success on a second link
        sec = router.section()["counters"]
        assert sec["Retry successes"] >= sec["Retries"] >= 1, sec
    finally:
        hold.set()
        _close(router, rfe, fes[1:])


def test_non_idempotent_command_is_never_retried():
    """A forwarded extension command whose backend dies either completed
    or comes back as a ``backend_lost`` error; it is never re-fired."""
    b1, b2 = StubBackend("b1", hold=threading.Event()), StubBackend("b2")
    router, rfe, fes = _fleet("port", [b1, b2])
    try:
        fes[1].stop()
        box = {}

        def fire():
            box["resp"] = request(
                "127.0.0.1", rfe.port,
                {"cmd": "feedback", "decision": "d1", "request_id": "fb-1"},
                timeout=10)

        t = threading.Thread(target=fire, daemon=True)
        t.start()
        deadline = time.monotonic() + 5
        while not b1.cmds and time.monotonic() < deadline:
            time.sleep(0.01)
        fes[0].stop()
        t.join(timeout=10)
        resp = box["resp"]
        assert resp.get("request_id") == "fb-1"
        if "error" in resp:
            assert resp.get("backend_lost")
        assert router.section()["counters"]["Retries"] == 0
    finally:
        rfe.stop()
        router.stop()


def test_lost_with_no_sibling_is_a_structured_error():
    b1 = StubBackend("b1", hold=threading.Event())     # never replies
    router, rfe, fes = _fleet("port", [b1])
    try:
        box = {}

        def fire():
            box["resp"] = request("127.0.0.1", rfe.port,
                                  {"model": "m", "row": "x",
                                   "request_id": "rq-z"}, timeout=10)

        t = threading.Thread(target=fire, daemon=True)
        t.start()
        deadline = time.monotonic() + 5
        while router.section()["counters"].get("Forwarded", 0) == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        fes[0].stop()
        t.join(timeout=10)
        resp = box["resp"]
        assert resp["request_id"] == "rq-z" and resp["backend_lost"]
        assert "error" in resp and resp["degraded"]
    finally:
        rfe.stop()
        router.stop()


# ---------------------------------------------------------------------------
# the lease and the control loop, step for step the reference's
# ---------------------------------------------------------------------------

def _lease_story(cls, cfg_cls, spool):
    """Two routers over one spool: acquire, follow, expire and promote,
    step down, release and hand off, then alternate holders."""
    def lease(label):
        return cls(cfg_cls({"router.lease.ttl.sec": "1.0"}), str(spool),
                   label)
    a, b = lease("router-a"), lease("router-b")
    out = [a.tick(now=100.0), a.generation(), b.tick(now=100.3),
           b.generation(), b.section()["holder"],
           b.tick(now=102.0), b.generation(), a.tick(now=102.1),
           a.generation(), a.section()["step_downs"]]
    b.release()
    out += [b.is_leader(), a.tick(now=102.2), a.generation()]
    now = 110.0
    for i in range(4):
        holder = (a, b)[i % 2]
        out += [holder.tick(now=now), holder.generation()]
        now += holder.ttl + 1.0
    out.append(json.loads(open(os.path.join(str(spool),
                                            "_router_lease")).read())[
        "generation"])
    return out


def test_lease_generations_and_handoff_equal_the_reference(tmp_path):
    mine = _lease_story(RouterLease, JobConfig, tmp_path / "port")
    theirs = _lease_story(JaxLease, JaxJobConfig, tmp_path / "jax")
    assert mine == theirs
    assert mine[:2] == [True, 1] and mine[6] == 2


class _CmdRecorder:
    """A backend link stand-in for the control loop: records commands."""

    def __init__(self, name, inflight=0):
        self.name = name
        self.sent = []
        self._inflight = inflight

    def alive(self):
        return True

    def inflight(self):
        return self._inflight

    def command(self, obj, timeout):
        self.sent.append(obj)
        return {"ok": True}


RATES = [(100.0, 35.0), (101.0, 35.0), (106.0, 5.0), (110.9, 5.0),
         (111.5, 5.0), (112.0, 50.0), (113.0, 0.0), (117.9, 0.0),
         (118.5, 0.0), (130.0, 12.0), (131.0, 12.0)]


def _autoscale(cls, cfg_cls):
    links = [_CmdRecorder("127.0.0.1:9001"), _CmdRecorder("127.0.0.1:9002")]
    rates = {"m": 0.0}
    loop = cls(cfg_cls({
        "router.autoscale.enable": "true",
        "router.autoscale.qps.per.replica": "10",
        "router.autoscale.min.replicas": "1",
        "router.autoscale.max.replicas": "4",
        "router.autoscale.hold.sec": "5",
        "router.control.interval.sec": "0"}), links, None,
        lambda: dict(rates))
    steps = []
    for now, rate in RATES:
        rates["m"] = rate
        loop.step(now=now)
        steps.append([list(c.get("replicas") for c in link.sent)
                      for link in links])
    return steps, loop.section()


def test_autoscale_decisions_equal_the_reference():
    """One rate sequence (surge, hold, a held scale-down, a second surge,
    idle): the port's loop issues the reference's scale commands at the
    same steps, up at once and down only after a full hold."""
    mine, theirs = (_autoscale(ControlLoop, JobConfig),
                    _autoscale(JaxControlLoop, JaxJobConfig))
    assert mine == theirs
    steps, sec = mine
    assert steps[0] == [[4], [4]] and steps[3] == [[4], [4]]
    assert steps[4] == [[4, 1], [4, 1]]
    assert sec["scale_ups"] >= 2 and sec["scale_downs"] >= 1


# ---------------------------------------------------------------------------
# the runbook module's rewrites for this tier
# ---------------------------------------------------------------------------

def test_rewrite_skips_device_on_router_and_fleetobs():
    text = ("$PY -m avenir_tpu serve \\\n  -Dserve.port=1 &\n"
            "$PY -m avenir_tpu router \\\n    -Drouter.backends=1,2 &\n"
            "$PY -m avenir_tpu fleetobs -Dfleetobs.spool.dir=s &\n"
            "$PY -m avenir_tpu fleetobs stitch --spool s --out t.json\n"
            "$PY -m avenir_tpu workload --scenario x.properties --assert\n")
    out = runbook._rewrite_shell(text, "cpu")
    lines = out.splitlines()
    assert lines[0] == "$PY -m avenir_tpu_torch serve --device cpu \\"
    assert lines[2] == "$PY -m avenir_tpu_torch router \\"
    assert lines[4] == ("$PY -m avenir_tpu_torch fleetobs "
                        "-Dfleetobs.spool.dir=s &")
    assert "--device" not in lines[5]
    assert lines[6].endswith("--assert --device cpu")
    runbook._leftover("run.sh", out)


def test_rewrite_argument_lists():
    text = ('p = [sys.executable, "-m", "avenir_tpu", "serve"] + defs\n'
            "q = [sys.executable, '-m', 'avenir_tpu', 'router', x]\n"
            '[sys.executable, "-m", "avenir_tpu", "fleetobs", y]\n')
    out = runbook._rewrite_helper(text, "cuda")
    assert out.splitlines() == [
        'p = [sys.executable, "-m", "avenir_tpu_torch", "serve", '
        '"--device", "cuda"] + defs',
        "q = [sys.executable, '-m', 'avenir_tpu_torch', 'router', x]",
        '[sys.executable, "-m", "avenir_tpu_torch", "fleetobs", y]']
    bare = runbook._rewrite_helper(text, None)
    assert '"avenir_tpu_torch", "serve"]' in bare and "--device" not in bare
    runbook._leftover("x.py", out)


def test_rewrite_keeps_the_names_of_core_imports():
    text = ("from avenir_tpu.core import obs\n"
            "from avenir_tpu.core import write_output\n"
            "from avenir_tpu.fleetobs import SpoolPublisher\n"
            "sys.path.insert(0, REPO)  # `python -m avenir_tpu\nrouter`\n")
    out = runbook._rewrite_helper(text, "cpu")
    assert out.splitlines()[:3] == [
        "from avenir_tpu_torch.core import obs",
        "from avenir_tpu_torch.core import write_output",
        "from avenir_tpu_torch.fleetobs import SpoolPublisher"]
    assert "-m avenir_tpu_torch\nrouter" in out
    runbook._leftover("x.py", out)
    from avenir_tpu_torch.core import obs, write_output  # noqa: F401


def test_rewrite_binds_a_job_class_to_the_device(tmp_path):
    """``resource/fleet/train.py`` builds ``BayesianDistribution``
    itself: the rewrite binds it to the device, and the script then
    writes the reference's model bytes (seed 11) on the CPU."""
    import subprocess
    import sys

    text = open(os.path.join(REPO, "resource", "fleet", "train.py")).read()
    out = runbook._rewrite_helper(text, "cpu")
    assert ("BayesianDistribution = __import__('functools').partial("
            "_port_BayesianDistribution, device='cpu')") in out
    runbook._leftover("train.py", out)
    assert "device=" not in runbook._rewrite_helper(text, None)
    port_py = tmp_path / "train.py"
    port_py.write_text(out)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    for script, dst in ((str(port_py), "port"),
                        (os.path.join(REPO, "resource", "fleet",
                                      "train.py"), "jax")):
        run = subprocess.run([sys.executable, script, str(tmp_path / dst)],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0, run.stderr
    part = os.path.join("nb_model", "part-r-00000")
    assert (open(tmp_path / "port" / part, "rb").read()
            == open(tmp_path / "jax" / part, "rb").read())


def test_sibling_directories_are_copied(tmp_path):
    """``resource/fleet/run.sh`` reads ``../workload/...``: the copy of
    the runbook gets the sibling beside it, and the rewritten script
    drives the port."""
    dst = tmp_path / "resource" / "fleet"
    script = runbook.port_runbook(os.path.join(REPO, "resource", "fleet"),
                                  str(dst), device="cpu")
    assert (tmp_path / "resource" / "workload" /
            "router_fleet.properties").exists()
    text = open(script).read()
    assert "-m avenir_tpu_torch router \\" in text
    assert "-m avenir_tpu_torch workload --device cpu \\" in text
    assert "BayesianDistribution = __import__" in open(
        dst / "train.py").read()


def test_router_smoke_through_the_port(tmp_path):
    """``resource/ci/router_smoke.py`` (CI gate 5): two ``serve --device
    cpu`` backends behind ``python -m avenir_tpu_torch router``, byte
    parity, a backend SIGKILLed mid-storm with none of 240 requests
    dropped, merged stats and the incident bundle."""
    out = runbook.run_script(os.path.join(REPO, "resource", "ci",
                                          "router_smoke.py"),
                             str(tmp_path), device="cpu", timeout=300)
    assert "router smoke: byte parity ok" in out
    assert ", 0 dropped" in out
