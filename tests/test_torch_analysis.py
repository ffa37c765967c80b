"""The port's static analyzer (``avenir_tpu_torch.analysis``) held
against the reference's (``avenir_tpu.analysis``) on the CPU.

Each fixture of ``tests/test_analysis.py`` is written once into a
``tmp_path`` corpus and run through the reference's rule function and the
port's: the ``Finding.to_dict()`` lists must be equal, in the same order,
with the same lines, messages and tags.  The two torch rules
(``torch-hot-path``, ``torch-bare-capture``) and the torch topology reads
take the torch spelling of the reference's JAX fixture, and their findings
must mirror the reference's on the JAX spelling: the same files, lines and
tags, with the rule id and the call's spelling mapped.  Then the engine,
the cache and the CLI, each against the reference's behaviour; every
sidecar here lives under ``tmp_path``.  The run of the whole catalog over
the port's own package is in ``tests/test_torch_analysis_coverage.py``.
"""

import json

import pytest

from avenir_tpu.analysis import (cache as r_cache, cli as r_cli,
                                 engine as r_engine, rules_algebra as r_alg,
                                 rules_concurrency as r_cc,
                                 rules_config as r_cfg, rules_io as r_io,
                                 rules_jax as r_jax, rules_serve as r_serve)
from avenir_tpu_torch.analysis import (cache as p_cache, cli as p_cli,
                                       engine as p_engine,
                                       rules_algebra as p_alg,
                                       rules_concurrency as p_cc,
                                       rules_config as p_cfg,
                                       rules_io as p_io,
                                       rules_serve as p_serve,
                                       rules_torch as p_torch)

_SEQ = [0]


def _write_tree(tmp_path, files, readme=None):
    _SEQ[0] += 1
    root = tmp_path / f"pkg{_SEQ[0]}"
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    readme_path = None
    if readme is not None:
        readme_path = tmp_path / f"README{_SEQ[0]}.md"
        readme_path.write_text(readme)
        readme_path = str(readme_path)
    return str(root), readme_path


def corpora(tmp_path, files, readme=None):
    """The reference's and the port's Corpus over one written tree."""
    root, readme_path = _write_tree(tmp_path, files, readme)
    return (r_engine.Corpus(root, readme_path=readme_path),
            p_engine.Corpus(root, readme_path=readme_path))


def dicts(findings):
    return [f.to_dict() for f in findings]


def tags(findings):
    return sorted(f.tag for f in findings)


# ---------------------------------------------------------------------------
# the fixtures of tests/test_analysis.py, verbatim
# ---------------------------------------------------------------------------

_RAW_IO = "def read_cfg():\n    return open('f').read()\n"
_WRAPPED_IO = ("def read_cfg():\n    return with_retries(_read)\n\n"
               "def _read():\n    return open('f').read()\n")
_TRUNC = "def save():\n    open('f', 'w').write('x')\n"
_APPEND_READ = ("def log():\n    open('f', 'a').write('x')\n"
                "def load():\n    return open('f').read()\n")

_UNLOCKED_RMW = """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        self.n += 1
"""

_LOCKED_RMW = """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        with self._lock:
            self.n += 1
"""

_WORKER_ONLY = """\
import threading

class C:
    def __init__(self):
        self.n = 0
        t = threading.Thread(target=self._run, daemon=True)
        t.start()

    def _run(self):
        while True:
            self.n += 1
"""

_HELPER_CREDIT = """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        with self._lock:
            self._bump()

    def _bump(self):
        self.n += 1
"""

_INCONSISTENT_ASSIGN = """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.state = "a"

    def set_locked(self, v):
        with self._lock:
            self.state = v

    def set_unlocked(self, v):
        self.state = v
"""

_MODULE_GLOBAL = """\
import threading

_LOCK = threading.Lock()
CACHE = {}

def put(k, v):
    CACHE[k] = v

def get(k):
    with _LOCK:
        return CACHE.get(k)
"""

_CONDITION_LOCKED = """\
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()
        self.items = []

    def push(self, x):
        with self._cv:
            self.items.append(x)
            self._cv.notify()
"""

_BAD_THREAD = ("import threading\n"
               "def spawn():\n"
               "    threading.Thread(target=print).start()\n")
_GOOD_THREAD = ("import threading\n"
                "def spawn():\n"
                "    threading.Thread(target=print, "
                "daemon=True).start()\n")
_THREAD_VAR = ("import threading\n"
               "def start():\n"
               "    t = threading.Thread(target=print)\n"
               "    t.start()\n")
_THREAD_DAEMON = ("import threading\n"
                  "def start():\n"
                  "    threading.Thread(target=print, daemon=True).start()\n")
_THREAD_JOINED = ("import threading\n"
                  "class W:\n"
                  "    def start(self):\n"
                  "        self._t = threading.Thread(target=print)\n"
                  "        self._t.start()\n"
                  "    def stop(self):\n"
                  "        self._t.join()\n")
_THREAD_SNEAKY = ("import threading\n"
                  "def start(out):\n"
                  "    t = threading.Thread(target=print)\n"
                  "    t.start()\n"
                  "    return out.join(',')\n")

_BREAKER_BAD = ("class CircuitBreaker:\n"
                "    def record_failure(self):\n"
                "        self.trips += 1\n")
_BREAKER_GOOD = ("class CircuitBreaker:\n"
                 "    def record_failure(self):\n"
                 "        self.trips += 1\n"
                 "        flight.trigger('breaker_trip')\n")

_IMPURE_CLOCK_SPEC = """\
import time


class BaseFoldSpec:
    pass


class ClockSpec(BaseFoldSpec):
    def encode(self, ctx):
        return (time.time(),)
"""

_IMPURE_RNG_SPEC = """\
import numpy as np


class BaseFoldSpec:
    pass


class ShuffleSpec(BaseFoldSpec):
    def encode(self, ctx):
        np.random.shuffle(ctx)
        return (ctx,)
"""

_IMPURE_ENV_SPEC = """\
import os


class BaseFoldSpec:
    pass


class EnvSpec(BaseFoldSpec):
    def finalize(self, carry):
        return os.environ.get("MODE")
"""

_IMPURE_GLOBAL_SPEC = """\
CACHE = {}


def fill(d):
    d["x"] = 1


def lookup(k):
    fill(CACHE)
    return CACHE.get(k)


class BaseFoldSpec:
    pass


class GlobalSpec(BaseFoldSpec):
    def finalize(self, carry):
        return lookup(carry)
"""

_PURE_SPEC = """\
import numpy as np


class BaseFoldSpec:
    pass


class CleanSpec(BaseFoldSpec):
    def encode(self, ctx):
        rng = np.random.default_rng(7)
        return (np.zeros(3), rng.integers(2))

    def finalize(self, carry):
        return carry
"""

_STAMPED_SPEC = ("import time\n\n\n"
                 "class BaseFoldSpec:\n"
                 "    pass\n\n\n"
                 "class StampedSpec(BaseFoldSpec):\n"
                 "    T0 = time.time()\n")

_STATE_ONLY = """\
class Window:
    def state_dict(self):
        return {"n": self.n}
"""

_STATE_FULL = """\
class Window:
    def state_dict(self):
        return {"n": self.n}

    @classmethod
    def from_state(cls, state):
        return cls()

    def merge(self, other):
        return self
"""

_SNAPSHOT_DROP = """\
def build_snapshot():
    snap = {}
    snap["counters"] = {}
    snap["extra"] = {}
    return snap


def merge_snapshots(a, b):
    out = {"counters": {}}
    for s in (a, b):
        out["counters"].update(s.get("counters") or {})
    return out
"""

_CPU_COUNT_SPEC = ("import os\n\n\n"
                   "class BaseFoldSpec:\n"
                   "    pass\n\n\n"
                   "class HostSizedSpec(BaseFoldSpec):\n"
                   "    def __init__(self):\n"
                   "        self.lanes = os.cpu_count()\n")

_TELEMETRY_GOOD = ('KEY_GOOD = "telemetry.good.key"\n'
                   'def f(config):\n'
                   '    return config.get_float(KEY_GOOD, 1.0)\n')

# ---------------------------------------------------------------------------
# fixture parity: the same findings, byte for byte
# ---------------------------------------------------------------------------

_TEL = r"(?:telemetry)"

#: rule -> (the reference's function, the port's function)
_RULE_FNS = {
    "io-retry": (r_io.io_retry_findings, p_io.io_retry_findings),
    "io-atomic-write": (r_io.io_atomic_findings, p_io.io_atomic_findings),
    "config-keys": (r_cfg.config_key_findings, p_cfg.config_key_findings),
    "lock-discipline": (r_cc.lock_discipline_findings,
                        p_cc.lock_discipline_findings),
    "thread-lifecycle": (r_cc.thread_lifecycle_findings,
                         p_cc.thread_lifecycle_findings),
    "flight-anomaly": (r_serve.flight_anomaly_findings,
                       p_serve.flight_anomaly_findings),
    "fold-purity": (r_alg.fold_purity_findings, p_alg.fold_purity_findings),
    "merge-closure": (r_alg.merge_closure_findings,
                      p_alg.merge_closure_findings),
    "carry-portability": (r_alg.carry_portability_findings,
                          p_alg.carry_portability_findings),
}

_MOD = ["mod.py"]
_CLOCK_KEY = "mod.py:ClockSpec.encode:time.time"

#: (case id, rule, files, keyword arguments (or positional for
#: config-keys), readme, the tags the case must produce)
_PARITY_CASES = [
    # io-retry: trigger, excluded, stale, empty reason, wrapped
    ("io-retry-trigger", "io-retry", {"mod.py": _RAW_IO},
     {"exclusions": {}, "modules": _MOD}, None, ["violation"]),
    ("io-retry-excluded", "io-retry", {"mod.py": _RAW_IO},
     {"exclusions": {"mod.py:read_cfg": "config read at startup"},
      "modules": _MOD}, None, []),
    ("io-retry-stale", "io-retry", {"mod.py": _RAW_IO},
     {"exclusions": {"mod.py:read_cfg": "startup",
                     "mod.py:gone": "was removed"}, "modules": _MOD},
     None, ["stale-exclusion"]),
    ("io-retry-empty-reason", "io-retry", {"mod.py": _RAW_IO},
     {"exclusions": {"mod.py:read_cfg": "  "}, "modules": _MOD}, None,
     ["empty-reason"]),
    ("io-retry-wrapped", "io-retry", {"mod.py": _WRAPPED_IO},
     {"exclusions": {}, "modules": _MOD}, None, []),
    # io-atomic-write
    ("io-atomic-trigger", "io-atomic-write", {"mod.py": _TRUNC},
     {"exclusions": {}}, None, ["violation"]),
    ("io-atomic-excluded", "io-atomic-write", {"mod.py": _TRUNC},
     {"exclusions": {"mod.py:save": "scratch file, never published"}},
     None, []),
    ("io-atomic-stale", "io-atomic-write", {"mod.py": _TRUNC},
     {"exclusions": {"mod.py:save": "scratch", "mod.py:other": "removed"}},
     None, ["stale-exclusion"]),
    ("io-atomic-append-read", "io-atomic-write", {"ok.py": _APPEND_READ},
     {"exclusions": {}}, None, []),
    # config-keys: bare literal, clean, never accessor-read, undocumented
    ("config-bare-literal", "config-keys",
     {"mod.py": 'def f(config):\n'
                '    return config.get("telemetry.bad.key")\n'},
     (_TEL,), "telemetry.bad.key documented", ["violation"]),
    ("config-clean", "config-keys", {"mod2.py": _TELEMETRY_GOOD}, (_TEL,),
     "`telemetry.good.key` documented here", []),
    ("config-never-read", "config-keys",
     {"mod3.py": 'KEY_DEAD = "telemetry.dead.key"\n'}, (_TEL,),
     "telemetry.dead.key", ["violation"]),
    ("config-undocumented", "config-keys", {"mod4.py": _TELEMETRY_GOOD},
     (_TEL,), "nothing here", ["violation"]),
    # lock-discipline: the seven fixtures, the module global's exclusion
    # and stale entry, and the sanitizer's lock factories
    ("lock-unlocked-rmw", "lock-discipline", {"mod.py": _UNLOCKED_RMW},
     {"exclusions": {}}, None, ["violation"]),
    ("lock-locked-rmw", "lock-discipline", {"mod.py": _LOCKED_RMW},
     {"exclusions": {}}, None, []),
    ("lock-helper-credit", "lock-discipline", {"mod.py": _HELPER_CREDIT},
     {"exclusions": {}}, None, []),
    ("lock-condition", "lock-discipline", {"mod.py": _CONDITION_LOCKED},
     {"exclusions": {}}, None, []),
    ("lock-worker-only", "lock-discipline", {"mod.py": _WORKER_ONLY},
     {"exclusions": {}}, None, []),
    ("lock-inconsistent-rebind", "lock-discipline",
     {"mod.py": _INCONSISTENT_ASSIGN}, {"exclusions": {}}, None,
     ["violation"]),
    ("lock-module-global", "lock-discipline", {"mod.py": _MODULE_GLOBAL},
     {"exclusions": {}}, None, ["violation"]),
    ("lock-module-global-excluded", "lock-discipline",
     {"mod.py": _MODULE_GLOBAL},
     {"exclusions": {"mod.py:<module>.CACHE":
                     "single-writer startup population"}}, None, []),
    ("lock-module-global-stale", "lock-discipline",
     {"mod.py": _MODULE_GLOBAL},
     {"exclusions": {"mod.py:<module>.CACHE": "startup",
                     "mod.py:C.gone": "class was deleted"}}, None,
     ["stale-exclusion"]),
    ("lock-sanitizer-factory", "lock-discipline",
     {"mod.py": _LOCKED_RMW.replace("threading.Lock()",
                                    'sanitizer.make_lock("x")')},
     {"exclusions": {}}, None, []),
    # thread-lifecycle
    ("thread-trigger", "thread-lifecycle", {"mod.py": _THREAD_VAR},
     {"exclusions": {}}, None, ["violation"]),
    ("thread-excluded", "thread-lifecycle", {"mod.py": _THREAD_VAR},
     {"exclusions": {"mod.py:start": "process-lifetime worker"}}, None, []),
    ("thread-stale", "thread-lifecycle", {"mod.py": _THREAD_VAR},
     {"exclusions": {"mod.py:start": "worker", "mod.py:gone": "removed"}},
     None, ["stale-exclusion"]),
    ("thread-daemon", "thread-lifecycle", {"d.py": _THREAD_DAEMON},
     {"exclusions": {}}, None, []),
    ("thread-joined", "thread-lifecycle", {"j.py": _THREAD_JOINED},
     {"exclusions": {}}, None, []),
    ("thread-sneaky-join", "thread-lifecycle", {"s.py": _THREAD_SNEAKY},
     {"exclusions": {}}, None, ["violation"]),
    ("thread-two-leaks", "thread-lifecycle",
     {"mod.py": _BAD_THREAD + "    threading.Thread(target=max).start()\n"},
     {"exclusions": {}}, None, ["violation", "violation"]),
    # flight-anomaly over the real site table: the breaker's missing hook
    # and a stale locator for every site the fixture does not carry
    ("flight-breaker-missing-hook", "flight-anomaly",
     {"serve/breaker.py": _BREAKER_BAD}, {}, None, None),
    ("flight-breaker-hooked", "flight-anomaly",
     {"serve/breaker.py": _BREAKER_GOOD}, {}, None, None),
    # fold-purity
    ("fold-clock", "fold-purity", {"mod.py": _IMPURE_CLOCK_SPEC},
     {"exclusions": {}, "extra_roots": {}}, None, ["violation"]),
    ("fold-clock-excluded", "fold-purity", {"mod.py": _IMPURE_CLOCK_SPEC},
     {"exclusions": {_CLOCK_KEY: "wall time never reaches the carry"},
      "extra_roots": {}}, None, []),
    ("fold-clock-stale", "fold-purity", {"mod.py": _IMPURE_CLOCK_SPEC},
     {"exclusions": {_CLOCK_KEY: "ok",
                     "mod.py:Gone.encode:time.time": "removed"},
      "extra_roots": {}}, None, ["stale-exclusion"]),
    ("fold-clock-empty-reason", "fold-purity",
     {"mod.py": _IMPURE_CLOCK_SPEC},
     {"exclusions": {_CLOCK_KEY: "  "}, "extra_roots": {}}, None,
     ["empty-reason"]),
    ("fold-rng", "fold-purity", {"mod.py": _IMPURE_RNG_SPEC},
     {"exclusions": {}, "extra_roots": {}}, None, ["violation"]),
    ("fold-env", "fold-purity", {"mod.py": _IMPURE_ENV_SPEC},
     {"exclusions": {}, "extra_roots": {}}, None, ["violation"]),
    ("fold-mutable-global", "fold-purity", {"mod.py": _IMPURE_GLOBAL_SPEC},
     {"exclusions": {}, "extra_roots": {}}, None, ["violation"]),
    ("fold-pure-seeded-rng", "fold-purity", {"mod.py": _PURE_SPEC},
     {"exclusions": {}, "extra_roots": {}}, None, []),
    ("fold-class-body", "fold-purity", {"mod.py": _STAMPED_SPEC},
     {"exclusions": {}, "extra_roots": {}}, None, ["violation"]),
    # merge-closure
    ("merge-state-only", "merge-closure", {"mod.py": _STATE_ONLY},
     {"exclusions": {}, "non_merged": {}}, None, ["violation"]),
    ("merge-state-only-excluded", "merge-closure", {"mod.py": _STATE_ONLY},
     {"exclusions": {"Window": "report-only surface"}, "non_merged": {}},
     None, []),
    ("merge-state-only-stale", "merge-closure", {"mod.py": _STATE_ONLY},
     {"exclusions": {"Window": "report-only", "Ghost": "deleted"},
      "non_merged": {}}, None, ["stale-exclusion"]),
    ("merge-state-full", "merge-closure", {"mod.py": _STATE_FULL},
     {"exclusions": {}, "non_merged": {}}, None, []),
    ("merge-snapshot-drop", "merge-closure",
     {"core/telemetry.py": _SNAPSHOT_DROP},
     {"exclusions": {}, "non_merged": {}}, None, ["violation"]),
    ("merge-snapshot-excluded", "merge-closure",
     {"core/telemetry.py": _SNAPSHOT_DROP},
     {"exclusions": {}, "non_merged": {"extra": "debug-only section"}},
     None, []),
    ("merge-snapshot-stale", "merge-closure",
     {"core/telemetry.py": _SNAPSHOT_DROP},
     {"exclusions": {}, "non_merged": {"extra": "debug",
                                       "ghost": "long gone"}},
     None, ["stale-exclusion"]),
    # carry-portability on a host read both packages patrol alike
    ("carry-cpu-count", "carry-portability", {"mod.py": _CPU_COUNT_SPEC},
     {"exclusions": {}, "extra_roots": {}}, None, ["violation"]),
    ("carry-cpu-count-excluded", "carry-portability",
     {"mod.py": _CPU_COUNT_SPEC},
     {"exclusions": {"mod.py:HostSizedSpec.__init__:os.cpu_count":
                     "display only"}, "extra_roots": {}}, None, []),
]


@pytest.mark.parametrize("case", _PARITY_CASES, ids=[c[0] for c in
                                                     _PARITY_CASES])
def test_fixture_findings_equal_the_reference(tmp_path, case):
    _cid, rule_id, files, args, readme, want_tags = case
    ref_c, port_c = corpora(tmp_path, files, readme)
    ref_fn, port_fn = _RULE_FNS[rule_id]
    if isinstance(args, tuple):
        ref, port = ref_fn(ref_c, *args), port_fn(port_c, *args)
    else:
        ref, port = ref_fn(ref_c, **args), port_fn(port_c, **args)
    assert dicts(port) == dicts(ref)
    assert all(f.rule == rule_id for f in port)
    if want_tags is not None:
        assert tags(port) == want_tags, [f.format() for f in port]


def test_flight_anomaly_fixture_reports_only_the_missing_hook(tmp_path):
    """The flight rule over a fixture that carries only the breaker: the
    breaker's scope lacks the hook in one and has it in the other, in
    both packages alike."""
    for src, want in ((_BREAKER_BAD, 1), (_BREAKER_GOOD, 0)):
        _ref_c, port_c = corpora(tmp_path, {"serve/breaker.py": src})
        got = [f for f in p_serve.flight_anomaly_findings(port_c)
               if f.file == "serve/breaker.py"]
        assert len(got) == want
        assert all("flight.trigger" in f.message for f in got)


def test_config_key_collection_equals_the_reference(tmp_path):
    ref_c, port_c = corpora(tmp_path, {"mod2.py": _TELEMETRY_GOOD},
                            readme="`telemetry.good.key`")
    assert (p_cfg.collect_config_keys(port_c, _TEL)
            == r_cfg.collect_config_keys(ref_c, _TEL)
            == {"telemetry.good.key": "KEY_GOOD"})


def test_io_scans_equal_the_reference(tmp_path):
    ref_c, port_c = corpora(tmp_path, {"mod.py": _WRAPPED_IO,
                                       "w.py": _TRUNC})
    assert (p_io.scan_ingest_io(port_c, modules=_MOD)
            == r_io.scan_ingest_io(ref_c, modules=_MOD))
    assert (p_io.scan_truncate_writes(port_c)
            == r_io.scan_truncate_writes(ref_c))


# ---------------------------------------------------------------------------
# the torch rules against the reference's JAX rules: the torch spelling
# of each JAX fixture gives the same files, lines and tags
# ---------------------------------------------------------------------------

def _mirrored(port_findings, ref_findings, rule_map, spelling):
    """Port findings mapped onto the reference's rule ids and spellings,
    beside the reference's: (rule, file, line, tag, message)."""
    def row(f, mapping):
        msg = f.message
        for theirs, ours in mapping.items():
            msg = msg.replace(theirs, ours)
        return (rule_map.get(f.rule, f.rule), f.file, f.line, f.tag, msg)
    return ([row(f, spelling) for f in port_findings],
            [row(f, {}) for f in ref_findings])


_HOT_JAX = ("class F:\n"
            "    def run(self, x):\n"
            "        x.block_until_ready()\n"
            "        return x\n"
            "    def cold(self, x):\n"
            "        x.block_until_ready()\n")
_HOT_TORCH = ("class F:\n"
              "    def run(self, x):\n"
              "        torch.cuda.synchronize()\n"
              "        return x\n"
              "    def cold(self, x):\n"
              "        torch.cuda.synchronize()\n")
_HOT_MAP = {"torch-hot-path": "jax-hot-path"}
_HOT_SPELLING = {"torch.cuda.synchronize": "block_until_ready"}


def _hot_variants():
    jax_key, torch_key = ("mod.py:F.run:block_until_ready",
                          "mod.py:F.run:torch.cuda.synchronize")
    return [
        ("trigger", {}, {}, ["violation"]),
        ("excluded", {jax_key: "end-of-scan barrier"},
         {torch_key: "end-of-scan barrier"}, []),
        ("stale", {jax_key: "barrier", "mod.py:F.gone:item": "removed"},
         {torch_key: "barrier", "mod.py:F.gone:item": "removed"},
         ["stale-exclusion"]),
    ]


@pytest.mark.parametrize("variant", _hot_variants(),
                         ids=[v[0] for v in _hot_variants()])
def test_torch_hot_path_mirrors_jax_hot_path(tmp_path, variant):
    _vid, ref_excl, port_excl, want = variant
    ref_c, _ = corpora(tmp_path, {"mod.py": _HOT_JAX})
    _, port_c = corpora(tmp_path, {"mod.py": _HOT_TORCH})
    ref = r_jax.jax_hot_path_findings(ref_c, hot_paths={"mod.py": ("F.run",)},
                                      exclusions=ref_excl)
    port = p_torch.torch_hot_path_findings(
        port_c, hot_paths={"mod.py": ("F.run",)}, exclusions=port_excl)
    mine, theirs = _mirrored(port, ref, _HOT_MAP, _HOT_SPELLING)
    assert mine == theirs
    assert tags(port) == want


@pytest.mark.parametrize("call", ["x.item()", "x.cpu()", "x.numpy()",
                                  "x.tolist()", "np.asarray(x)",
                                  "np.array(x)", "float(x)",
                                  "torch.cuda.synchronize()",
                                  "ev.synchronize()"])
def test_torch_hot_path_flags_each_host_sync(tmp_path, call):
    src = (f"import numpy as np\nimport torch\n"
           f"def hot(x, ev):\n    return {call}\n"
           f"def cold(x, ev):\n    return {call}\n"
           f"def literal(x):\n    return float(1.5)\n")
    _, port_c = corpora(tmp_path, {"mod.py": src})
    got = p_torch.torch_hot_path_findings(
        port_c, hot_paths={"mod.py": ("hot", "literal")}, exclusions={})
    assert [(f.line, f.tag) for f in got] == [(4, "violation")]
    assert "inside registered hot path hot" in got[0].message


_JIT_JAX = "import jax\ndef build(f):\n    return jax.jit(f)\n"
_JIT_OK = ("from . import telemetry\n"
           "def build(f):\n    return telemetry.profiled_jit(f, 'x')\n")


@pytest.mark.parametrize("spelling", [
    "import torch\ndef build(f):\n    return torch.compile(f)\n",
    "from .graphs import GraphedCall\n"
    "def build(f):\n    return GraphedCall(f, 'cuda')\n",
    "from . import graphs\n"
    "def build(f):\n    return graphs.GraphedCall(f, 'cuda')\n",
    "from .graphs import GraphedCall\n"
    "def build(f):\n    g = GraphedCall(f, 'cuda')\n    return g\n"])
def test_torch_bare_capture_mirrors_jax_bare_jit(tmp_path, spelling):
    ref_c, _ = corpora(tmp_path, {"mod.py": _JIT_JAX})
    _, port_c = corpora(tmp_path, {"mod.py": spelling})
    ref = r_jax.jax_bare_jit_findings(ref_c, modules=("mod.py",))
    port = p_torch.torch_bare_capture_findings(port_c, modules=("mod.py",))
    assert [(f.file, f.line, f.tag) for f in port] \
        == [(f.file, f.line, f.tag) for f in ref] == [("mod.py", 3,
                                                        "violation")]
    assert "in build on a serving/pipeline path" in port[0].message
    assert port[0].rule == "torch-bare-capture"


@pytest.mark.parametrize("spelling", [
    "from . import telemetry\n"
    "def build(f):\n    return telemetry.profiled_build(f, 'x')\n",
    "from . import telemetry\nfrom .graphs import GraphedCall\n"
    "def build(f):\n"
    "    return telemetry.profiled_build(GraphedCall(f, 'cuda'), 'x')\n",
    "from . import telemetry\nfrom .graphs import GraphedCall\n"
    "def build(f, dev):\n"
    "    if dev == 'cuda':\n"
    "        f = GraphedCall(f, dev)\n"
    "    return telemetry.profiled_build(f, 'x')\n"])
def test_torch_bare_capture_passes_billed_builds(tmp_path, spelling):
    ref_c, _ = corpora(tmp_path, {"ok.py": _JIT_OK})
    _, port_c = corpora(tmp_path, {"ok.py": spelling})
    assert r_jax.jax_bare_jit_findings(ref_c, modules=("ok.py",)) == []
    assert p_torch.torch_bare_capture_findings(port_c,
                                               modules=("ok.py",)) == []


def test_bare_capture_billing_is_per_scope(tmp_path):
    """A name handed to profiled_build in one function does not bill a
    capture bound to the same name in another."""
    src = ("from . import telemetry\nfrom .graphs import GraphedCall\n"
           "def a(f):\n    return telemetry.profiled_build(f, 'x')\n"
           "def b(f):\n    f = GraphedCall(f, 'cuda')\n    return f\n")
    _, port_c = corpora(tmp_path, {"serve/m.py": src})
    got = p_torch.torch_bare_capture_findings(port_c)
    assert [(f.line, f.tag) for f in got] == [(6, "violation")]


_TOPO_JAX = ("import jax\n\n\n"
             "class BaseFoldSpec:\n"
             "    pass\n\n\n"
             "class DeviceSizedSpec(BaseFoldSpec):\n"
             "    def __init__(self):\n"
             "        self.lanes = jax.device_count()\n")
_CLASS_TOPO_JAX = ("import jax\n\n\n"
                   "class BaseFoldSpec:\n"
                   "    pass\n\n\n"
                   "class ClassLevelSpec(BaseFoldSpec):\n"
                   "    LANES = jax.device_count()\n")
_TOPO_READS = {"torch.cuda.device_count": "jax.device_count",
               "torch.cuda.current_device": "jax.process_index",
               "torch.distributed.get_rank": "jax.process_index",
               "torch.distributed.get_world_size": "jax.process_count"}


@pytest.mark.parametrize("fixture", [_TOPO_JAX, _CLASS_TOPO_JAX],
                         ids=["init", "class-body"])
@pytest.mark.parametrize("ours", sorted(_TOPO_READS))
def test_carry_portability_torch_reads_mirror_jax_reads(tmp_path, fixture,
                                                         ours):
    theirs = _TOPO_READS[ours]
    ref_src = fixture.replace("jax.device_count", theirs)
    port_src = fixture.replace("import jax", "import torch").replace(
        "jax.device_count", ours)
    qual = ("DeviceSizedSpec.__init__" if "__init__" in fixture
            else "ClassLevelSpec.<class>")
    for excl_of in (lambda t: {}, lambda t: {f"mod.py:{qual}:{t}": "shown"},
                    lambda t: {f"mod.py:{qual}:{t}": "shown",
                               "mod.py:Gone.__init__:os.cpu_count": "gone"}):
        ref_c, port_c = (corpora(tmp_path, {"mod.py": ref_src})[0],
                         corpora(tmp_path, {"mod.py": port_src})[1])
        ref = r_alg.carry_portability_findings(
            ref_c, exclusions=excl_of(theirs), extra_roots={})
        port = p_alg.carry_portability_findings(
            port_c, exclusions=excl_of(ours), extra_roots={})
        mine, want = _mirrored(port, ref, {}, {ours: theirs})
        assert mine == want
        assert len(port) == 1 or excl_of(ours)
    # the reference's JAX spelling names nothing in the port's table
    _, port_c = corpora(tmp_path, {"mod.py": fixture})
    assert p_alg.carry_portability_findings(port_c, exclusions={},
                                            extra_roots={}) == []


def test_absolute_imports_of_the_port_resolve_in_its_call_graph(tmp_path):
    """The dataflow pass strips ``avenir_tpu_torch.`` off an absolute
    import, so a fold that reaches an impure helper through one is seen;
    the reference's engine strips only ``avenir_tpu.``."""
    files = {
        "helpers.py": "import time\n\ndef stamp():\n    return time.time()\n",
        "spec.py": ("from avenir_tpu_torch.helpers import stamp\n\n\n"
                    "class BaseFoldSpec:\n    pass\n\n\n"
                    "class S(BaseFoldSpec):\n"
                    "    def encode(self, ctx):\n        return stamp()\n"),
    }
    ref_c, port_c = corpora(tmp_path, files)
    got = p_alg.fold_purity_findings(port_c, exclusions={}, extra_roots={})
    assert [(f.file, f.tag) for f in got] == [("helpers.py", "violation")]
    assert "stamp calls time.time()" in got[0].message
    assert r_alg.fold_purity_findings(ref_c, exclusions={},
                                      extra_roots={}) == []


# ---------------------------------------------------------------------------
# engine mechanics
# ---------------------------------------------------------------------------

def test_finding_format_and_json_round_trip_equal_the_reference():
    args = ("rule-x", "a/b.py", 12, "the message")
    ref = r_engine.Finding(*args, hint="do this")
    port = p_engine.Finding(*args, hint="do this")
    assert port.format() == ref.format() \
        == "rule-x  a/b.py:12  the message  [fix: do this]"
    assert port.to_dict() == ref.to_dict()
    back = p_engine.Finding(**json.loads(json.dumps(port.to_dict())))
    assert back.to_dict() == port.to_dict()
    assert p_engine.Finding("r", "f.py", 0, "m").format() == "r  f.py  m"


def test_run_rules_unknown_rule_raises(tmp_path):
    _, port_c = corpora(tmp_path, {"m.py": "x = 1\n"})
    with pytest.raises(KeyError, match="no-such-rule"):
        p_engine.run_rules(port_c, rule_ids=["no-such-rule"])


def test_catalog_is_the_references_with_the_torch_rules():
    from avenir_tpu.analysis import RULES as ref_rules
    from avenir_tpu_torch.analysis import RULES as port_rules
    mapped = {"jax-hot-path": "torch-hot-path",
              "jax-bare-jit": "torch-bare-capture"}
    assert len(port_rules) == len(ref_rules) == 17
    assert set(port_rules) == {mapped.get(r, r) for r in ref_rules}
    for rid, rule in port_rules.items():
        assert rule.doc
        ref_id = {v: k for k, v in mapped.items()}.get(rid, rid)
        assert rule.scope == ref_rules[ref_id].scope


def test_findings_sort_deterministically_by_file_line_rule(tmp_path):
    src_ref = ("import jax\nimport threading\n"
               "def build(f):\n    return jax.jit(f)\n"
               "def spawn():\n    threading.Thread(target=print).start()\n")
    src_port = src_ref.replace("import jax", "import torch").replace(
        "jax.jit", "torch.compile")
    ref_c, _ = corpora(tmp_path, {"serve/b.py": src_ref,
                                  "serve/a.py": src_ref})
    _, port_c = corpora(tmp_path, {"serve/b.py": src_port,
                                   "serve/a.py": src_port})
    ref, _ = r_engine.run_rules(ref_c, rule_ids=["thread-lifecycle",
                                                 "jax-bare-jit"])
    port, report = p_engine.run_rules(port_c, rule_ids=[
        "thread-lifecycle", "torch-bare-capture"])
    keys = [(f.file, f.line, f.rule) for f in port]
    assert len(keys) == 4 and keys == sorted(keys)
    assert keys[0][0] == "serve/a.py"
    assert [(f.file, f.line) for f in port] == [(f.file, f.line)
                                                for f in ref]
    for entry in report["rules"]:
        assert set(entry) == {"rule", "findings", "ms"}
        assert entry["ms"] >= 0


# ---------------------------------------------------------------------------
# the cache (every sidecar under tmp_path)
# ---------------------------------------------------------------------------

def test_cache_parse_reuse_and_touch_one_file_invalidation(tmp_path):
    root = tmp_path / "pkg"
    root.mkdir()
    (root / "mod.py").write_text(_BAD_THREAD)
    cache_dir = str(tmp_path / "sidecar")

    cold = p_cache.AnalysisCache(cache_dir)
    c1 = cold.load_corpus(str(root))
    assert cold.stats["parsed"] == 1
    f1, r1 = cold.run(c1, rule_ids=["thread-lifecycle"])
    assert r1["cached"] is False and len(f1) == 1

    warm = p_cache.AnalysisCache(cache_dir)
    c2 = warm.load_corpus(str(root))
    assert warm.stats["parsed"] == 0 and warm.stats["reused"] == 1
    f2, r2 = warm.run(c2, rule_ids=["thread-lifecycle"])
    assert r2["cached"] is True and warm.stats["report_hit"]
    assert dicts(f2) == dicts(f1)

    (root / "mod.py").write_text(_GOOD_THREAD)
    inval = p_cache.AnalysisCache(cache_dir)
    c3 = inval.load_corpus(str(root))
    assert inval.stats["parsed"] == 1
    f3, r3 = inval.run(c3, rule_ids=["thread-lifecycle"])
    assert r3["cached"] is False and f3 == []


def test_cache_digests_agree_and_equal_the_reference(tmp_path):
    root = tmp_path / "pkg"
    (root / "sub").mkdir(parents=True)
    (root / "cli.py").write_text("x = 1\n")
    (root / "sub" / "mod.py").write_text("y = 2\n")
    readme = tmp_path / "README.md"
    readme.write_text("docs\n")
    port = p_cache.AnalysisCache(str(tmp_path / "a"))
    ref = r_cache.AnalysisCache(str(tmp_path / "b"))
    corpus = p_engine.Corpus(str(root), readme_path=str(readme))
    digest = port.tree_digest(str(root), readme_path=str(readme))
    assert digest == port.corpus_digest(corpus)
    assert digest == ref.tree_digest(str(root), readme_path=str(readme))


def test_port_sidecar_is_its_own_directory():
    """The port's sidecar sits beside the package as
    ``.avenir-analyze-torch/``, never the reference's
    ``.avenir-analyze/``, whose warm-replay test would otherwise see a
    port run rewrite its reports."""
    import os

    import avenir_tpu_torch
    d = p_cache.default_cache_dir()
    assert os.path.basename(d) == ".avenir-analyze-torch"
    assert os.path.dirname(d) == os.path.dirname(os.path.dirname(
        os.path.abspath(avenir_tpu_torch.__file__)))
    assert d != r_cache.default_cache_dir()
    assert p_cache.AnalysisCache().dir == d


def test_warm_package_run_replays_without_parsing(tmp_path):
    cache_dir = str(tmp_path / "sidecar")
    rules = ["wire-identity", "flight-anomaly"]
    _f, cold = p_cache.cached_package_run(rule_ids=rules,
                                          cache_dir=cache_dir)
    assert cold["cached"] is False
    findings, report = p_cache.cached_package_run(rule_ids=rules,
                                                  cache_dir=cache_dir)
    assert report["cached"] is True
    assert report["cache_stats"]["parsed"] == 0
    assert findings == []
    assert report["files"] > 50


# ---------------------------------------------------------------------------
# the CLI (the analyzed corpus planted through load_package_corpus)
# ---------------------------------------------------------------------------

def _plant(monkeypatch, tmp_path, files):
    _, port_c = corpora(tmp_path, files)
    monkeypatch.setattr(p_cli, "load_package_corpus", lambda: port_c)
    return port_c


def test_cli_strict_fails_on_findings(tmp_path, monkeypatch):
    _plant(monkeypatch, tmp_path, {"mod.py": _UNLOCKED_RMW})
    base = ["--no-cache", "--rules", "lock-discipline"]
    assert p_cli.analyze_main(base + ["--strict"]) == 1
    assert p_cli.analyze_main(base) == 0
    assert p_cli.analyze_main(["--no-cache", "--rules", "nope"]) == 2
    assert p_cli.analyze_main(["--bogus"]) == 2


def test_cli_exit_codes_equal_the_reference(tmp_path, monkeypatch):
    ref_c, port_c = corpora(tmp_path, {"mod.py": _UNLOCKED_RMW})
    monkeypatch.setattr(r_cli, "load_package_corpus", lambda: ref_c)
    monkeypatch.setattr(p_cli, "load_package_corpus", lambda: port_c)
    for argv in (["--no-cache", "--strict", "--rules", "lock-discipline"],
                 ["--no-cache", "--rules", "lock-discipline"],
                 ["--no-cache", "--rules", "nope"], ["--bogus"],
                 ["--seeds", "0"], ["--seeds", "x"],
                 ["--update-baseline"], ["--baseline"],
                 ["--baseline", "--update-baseline"],
                 ["--json", "--strict"], ["--rules", "--strict"]):
        assert p_cli.analyze_main(list(argv)) == r_cli.analyze_main(
            list(argv)), argv


def test_cli_json_report_lists_the_planted_finding(tmp_path, monkeypatch):
    _plant(monkeypatch, tmp_path, {"mod.py": _UNLOCKED_RMW})
    out = str(tmp_path / "findings.json")
    assert p_cli.analyze_main(["--no-cache", "--rules", "lock-discipline",
                               "--json", out]) == 0
    data = json.loads(open(out).read())
    # the package's own registry entries name sites the fixture lacks, so
    # they report stale beside the planted violation
    hits = [f for f in data["findings"] if f["tag"] == "violation"]
    assert [(f["rule"], f["file"], f["line"]) for f in hits] == [
        ("lock-discipline", "mod.py", 9)]
    assert data["total_findings"] == len(data["findings"])
    assert data["cached"] is False


def test_cli_baseline_ratchet(tmp_path, monkeypatch):
    base = str(tmp_path / "baseline.json")
    args = ["--no-cache", "--strict", "--rules", "thread-lifecycle",
            "--baseline", base]
    _plant(monkeypatch, tmp_path, {"mod.py": _BAD_THREAD})
    assert p_cli.analyze_main(args) == 1
    assert p_cli.analyze_main(args + ["--update-baseline"]) == 0
    stored = json.load(open(base))
    assert len(stored["findings"]) == 1
    assert stored["findings"][0]["rule"] == "thread-lifecycle"
    assert p_cli.analyze_main(args) == 0
    _plant(monkeypatch, tmp_path, {"mod.py": _BAD_THREAD,
                                   "other.py": _BAD_THREAD})
    assert p_cli.analyze_main(args) == 1
    _plant(monkeypatch, tmp_path, {"mod.py": _GOOD_THREAD})
    assert p_cli.analyze_main(args) == 0


def test_cli_baseline_counts_duplicate_findings(tmp_path, monkeypatch):
    """A second identical violation in the same file must not hide behind
    one baselined occurrence (the ratchet is a multiset diff)."""
    base = str(tmp_path / "dupes.json")
    args = ["--no-cache", "--strict", "--rules", "thread-lifecycle",
            "--baseline", base]
    _plant(monkeypatch, tmp_path, {"mod.py": _BAD_THREAD})
    assert p_cli.analyze_main(args + ["--update-baseline"]) == 0
    assert p_cli.analyze_main(args) == 0
    two = _plant(monkeypatch, tmp_path, {
        "mod.py": _BAD_THREAD + "    threading.Thread(target=max).start()\n"})
    got = p_cc.thread_lifecycle_findings(two, exclusions={})
    assert len(got) == 2 and got[0].message == got[1].message
    assert p_cli.analyze_main(args) == 1


def test_cli_flag_values_never_swallow_flags():
    for argv in (["--baseline", "--update-baseline"], ["--json", "--strict"],
                 ["--rules", "--strict"], ["--device", "--dynamic"],
                 ["--seeds", "--strict"]):
        assert p_cli.analyze_main(argv) == 2, argv


def test_cli_list_prints_all_17_ids(capsys):
    assert p_cli.analyze_main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ids = [ln.split()[0] for ln in lines]
    assert len(ids) == 17
    assert ids == sorted(p_engine.RULES)
    assert {"torch-hot-path", "torch-bare-capture"} <= set(ids)


def test_top_level_cli_dispatches_analyze(capsys):
    from avenir_tpu_torch.cli import main
    assert main(["analyze", "--list"]) == 0
    assert "torch-hot-path" in capsys.readouterr().out


def test_analysis_runbook_rewrites_to_the_port(tmp_path):
    """resource/analysis/run.sh runs through runbook.py: every analyze
    line is the port's, with the device flag."""
    import os

    from avenir_tpu_torch.runbook import port_runbook
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = port_runbook(os.path.join(repo, "resource", "analysis"),
                          str(tmp_path / "analysis"), "cpu")
    text = open(script).read()
    lines = [ln for ln in text.splitlines() if " analyze" in ln
             and "-m " in ln]
    assert len(lines) == 5
    for ln in lines:
        assert "-m avenir_tpu_torch analyze" in ln
        assert ln.endswith("--device cpu")
