"""Serving-layer rules: flight-recorder anomaly coverage and
wire-response identity echo.

The port's copy of ``avenir_tpu/analysis/rules_serve.py``, over the
port's serving layer (a copy of the reference's):

- **flight-anomaly** — every anomaly trigger site in the package
  (breaker trips, SLO soft-degrades, poison quarantines, torn
  artifacts, systemic scorer failures) calls the flight-dump hook
  (``flight.trigger``) in its enclosing scope, or sits on
  ``ANOMALY_EXCLUDED`` with a reason.
- **wire-identity** — every response-construction site in
  ``serve/server.py`` is on the ``_finish_response`` funnel (which
  echoes ``request_id``/``trace_id``) or pinned in
  ``RESPONSE_SITES_OK`` with a reason; the frontend's out-of-funnel
  renderers are pinned likewise, and the drain filler demonstrably
  echoes the captured ``request_id``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List

from .engine import Corpus, Finding, enclosing_scope_source, rule

#: every anomaly trigger site in the package: description ->
#: (module path, a regex that locates the site).  The enclosing
#: function/class scope must call ``flight.trigger`` — or the
#: description sits on ANOMALY_EXCLUDED with a reason.
ANOMALY_SITES: Dict[str, tuple] = {
    "breaker trip (closed/half-open -> open)":
        ("serve/breaker.py", r"self\.trips \+= 1"),
    "SLO sustained violation -> soft-degrade":
        ("serve/slo.py", r"set_soft_degraded\(\s*True"),
    "systemic scorer failure (whole-batch exception)":
        ("serve/batcher.py", r"record_failure\("),
    "poison row crosses into quarantine":
        ("serve/batcher.py", r"quarantine\.record\("),
    "torn artifact detected":
        ("core/io.py", r"class TornArtifactError"),
    "lock-order cycle detected (sanitizer teardown)":
        ("core/sanitizer.py", r"raise LockOrderCycle\("),
}

#: sites deliberately NOT wired to the flight hook, with reasons
ANOMALY_EXCLUDED: Dict[str, str] = {
    "lock-order cycle detected (sanitizer teardown)":
        "the sanitizer is a test-harness teardown check: the raising "
        "test IS the report, and a flight dump from inside the lock "
        "instrumentation layer could itself take locks",
}

#: serve/server.py functions allowed to BUILD response dicts
RESPONSE_SITES_OK: Dict[str, str] = {
    "_finish_response": "the chokepoint itself",
    "handle_line": "pre-parse JSON errors only: request_id unreadable "
                   "by definition; parsed requests funnel through "
                   "_finish_response",
    "dispatch_line": "pre-parse errors before the cb wrapper installs; "
                     "all post-parse cb calls ride the funnel",
    "_handle_obj": "returns into handle_line/dispatch_line funnels",
    "_command": "returns into the funnels via _handle_obj",
    "_submit": "returns into _predict -> funnels",
    "_evicted_mid_request": "returns into _submit's cold-start paths "
                            "-> _predict -> funnels",
    "_assemble": "returns into _predict/_AsyncCollector -> funnels",
    "_finish": "_AsyncCollector: fires the wrapped (funnel) callback",
}

#: frontend.py response-producing functions (they render bytes directly,
#: outside the server funnel) and why each is identity-correct
FRONTEND_SITES_OK: Dict[str, str] = {
    "_dispatch_error": "oversized/skimmed line: the request was never "
                       "parsed, so no request_id exists to echo",
    "fail_pending": "drain-timeout filler: echoes request_id from "
                    "conn.meta (captured at dispatch) — asserted by the "
                    "rule",
}


@rule("flight-anomaly",
      "every anomaly trigger site calls flight.trigger in its enclosing "
      "scope or sits on ANOMALY_EXCLUDED with a reason")
def flight_anomaly_findings(corpus: Corpus) -> List[Finding]:
    out: List[Finding] = []
    for what, (rel, pattern) in sorted(ANOMALY_SITES.items()):
        excluded = what in ANOMALY_EXCLUDED
        if excluded and not ANOMALY_EXCLUDED[what].strip():
            out.append(Finding(
                "flight-anomaly", rel, 0,
                f"ANOMALY_EXCLUDED entry {what!r} has no written "
                f"reason", tag="empty-reason"))
            continue
        sf = corpus.get(rel)
        text = sf.text if sf is not None else ""
        matches = list(re.finditer(pattern, text))
        if not matches:
            # the staleness check runs for EXCLUDED entries too: an
            # exclusion whose locator no longer matches is a rotten
            # registry entry, same as everywhere else
            out.append(Finding(
                "flight-anomaly", rel, 0,
                f"anomaly site pattern for {what!r} no longer matches "
                f"{rel}",
                hint="stale ANOMALY_SITES entry? update the locator",
                tag="stale-exclusion"))
            continue
        if excluded:
            continue
        for m in matches:
            lineno = text[:m.start()].count("\n") + 1
            scope = enclosing_scope_source(text, lineno, tree=sf.tree)
            if "flight.trigger" not in scope:
                out.append(Finding(
                    "flight-anomaly", rel, lineno,
                    f"anomaly site ({what}) scope has no flight.trigger "
                    f"call",
                    hint="dump the black box at the anomaly edge, or "
                         "add to ANOMALY_EXCLUDED with a reason"))
    return out


# ---------------------------------------------------------------------------
# wire-identity
# ---------------------------------------------------------------------------

def response_building_functions(sf) -> Dict[str, List[int]]:
    """{enclosing function name: [line numbers]} for every dict literal
    carrying an ``"error"``/``"output"``/``"outputs"`` key — the
    response-construction sites."""
    tree = sf.tree
    sites: Dict[str, List[int]] = {}
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    wire_keys = {"error", "output", "outputs"}

    def hit(node) -> bool:
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
            return bool(keys & wire_keys)
        if isinstance(node, ast.Assign):
            # resp["error"] = ... — assembled responses, not literals
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and t.slice.value in wire_keys):
                    return True
        return False

    for node in ast.walk(tree):
        if not hit(node):
            continue
        owner = None
        for f in funcs:
            if f.lineno <= node.lineno <= (f.end_lineno or f.lineno):
                if owner is None or f.lineno > owner.lineno:
                    owner = f
        sites.setdefault(owner.name if owner else "<module>",
                         []).append(node.lineno)
    return sites


@rule("wire-identity",
      "every wire response construction site rides the request_id/"
      "trace_id echo funnel or is pinned with a reason")
def wire_identity_findings(corpus: Corpus) -> List[Finding]:
    out: List[Finding] = []
    srv = corpus.get("serve/server.py")
    fe = corpus.get("serve/frontend.py")
    if srv is None or fe is None:
        return out          # fixture corpora carry no serve layer
    srv_sites = response_building_functions(srv)
    for fn in sorted(set(srv_sites) - set(RESPONSE_SITES_OK)):
        out.append(Finding(
            "wire-identity", "serve/server.py", srv_sites[fn][0],
            f"new response-construction site {fn}() not classified for "
            f"identity echo",
            hint="route through _finish_response or add to "
                 "RESPONSE_SITES_OK with a reason"))
    for fn in sorted(set(RESPONSE_SITES_OK) - set(srv_sites)):
        out.append(Finding(
            "wire-identity", "serve/server.py", 0,
            f"stale RESPONSE_SITES_OK entry {fn!r}: no such "
            f"response-construction site exists anymore",
            hint="drop the entry", tag="stale-exclusion"))
    # the funnel really exists and echoes both identities
    for needle in ('setdefault("request_id"', 'setdefault("trace_id"'):
        if needle not in srv.text:
            out.append(Finding(
                "wire-identity", "serve/server.py", 0,
                f"_finish_response funnel no longer echoes via {needle}",
                hint="the chokepoint must stamp request_id and trace_id"))
    fe_sites = response_building_functions(fe)
    for fn in sorted(set(fe_sites) - set(FRONTEND_SITES_OK)):
        out.append(Finding(
            "wire-identity", "serve/frontend.py", fe_sites[fn][0],
            f"new response-construction site {fn}() outside the server "
            f"funnel",
            hint="add to FRONTEND_SITES_OK with a reason"))
    for fn in sorted(set(FRONTEND_SITES_OK) - set(fe_sites)):
        out.append(Finding(
            "wire-identity", "serve/frontend.py", 0,
            f"stale FRONTEND_SITES_OK entry {fn!r}",
            hint="drop the entry", tag="stale-exclusion"))
    if "fail_pending" in fe_sites:
        fail_src = enclosing_scope_source(
            fe.text, fe_sites["fail_pending"][0], tree=fe.tree)
        if "request_id" not in fail_src or "conn.meta" not in fail_src:
            out.append(Finding(
                "wire-identity", "serve/frontend.py",
                fe_sites["fail_pending"][0],
                "drain filler no longer echoes request_id from "
                "conn.meta",
                hint="the filler must echo the identity captured at "
                     "dispatch"))
    return out
