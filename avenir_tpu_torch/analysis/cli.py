"""``python -m avenir_tpu_torch analyze``: run the rule catalog over the
package.

Usage::

    python -m avenir_tpu_torch analyze [--strict] [--json report.json]
                                       [--rules id1,id2] [--list]
                                       [--no-cache]
                                       [--baseline findings.json]
                                       [--update-baseline]
                                       [--dynamic] [--seeds N]
                                       [--device cpu|cuda]

- default: print findings as text lines (``rule  file:line  message``)
  plus a one-line summary; exit 0 regardless of findings.  Warm runs
  are incremental: unchanged files are never re-parsed and an unchanged
  corpus replays the previous findings (sidecar under
  ``.avenir-analyze-torch/``; ``--no-cache`` forces a cold run).
- ``--strict``: exit 1 when any unexcluded finding (including stale
  exclusions / empty reasons) survives — the CI gate.  With
  ``--baseline`` only NEW findings (absent from the baseline) fail.
- ``--json <path>``: also write the machine-readable findings report
  (atomic publish, the CI artifact; includes per-rule wall time and
  finding counts, findings sorted (file, line, rule)).
- ``--rules a,b``: run a subset of the catalog.
- ``--list``: print the rule catalog (id, scope, doc) and exit.
- ``--baseline <path>``: ratchet mode — diff findings against the
  committed baseline and fail only on new ones, so a new rule can land
  before its cleanups finish.  ``--update-baseline`` rewrites the
  baseline atomically from the current findings.
- ``--dynamic``: after the static catalog, run the fold-algebra
  split-invariance verifier (core.algebra) over every registered
  FoldSpec and the snapshot/histogram merges; any failed property
  exits 1 regardless of ``--strict``.  ``--seeds N`` controls how many
  seeds each property runs under (default 3).  It runs on ``cuda:0``
  unless ``--device cpu`` asks for the CPU (``AVENIR_MESH`` shapes the
  mesh as for every other entry point), and raises without a card
  otherwise.  The static catalog touches no device and ignores
  ``--device``.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from .engine import (RULES, all_rule_ids, load_package_corpus, run_rules,
                     write_json_report)


def _finding_key(d: dict) -> tuple:
    """Baseline identity for one finding: line numbers drift with
    unrelated edits, so the ratchet matches on stable content."""
    return (d["rule"], d["file"], d["message"], d.get("tag", "violation"))


def _load_baseline(path: str) -> Optional[List[dict]]:
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        raise SystemExit(f"analyze: unreadable baseline {path}: {exc}")
    if isinstance(data, dict):
        return list(data.get("findings", []))
    raise SystemExit(f"analyze: baseline {path} is not a findings dict")


def analyze_main(argv: List[str]) -> int:
    strict = False
    json_out: Optional[str] = None
    rule_ids = None
    list_rules = False
    use_cache = True
    baseline_path: Optional[str] = None
    update_baseline = False
    dynamic = False
    n_seeds = 3
    device: Optional[str] = None
    i = 0
    while i < len(argv):
        a = argv[i]

        def value(flag):
            nonlocal i
            if a.startswith(flag + "="):
                v = a.partition("=")[2]
            else:
                i += 1
                v = argv[i] if i < len(argv) else ""
            if not v or v.startswith("--"):
                # a following flag is NOT a value: `--baseline
                # --update-baseline` must be a usage error, not a
                # baseline file literally named "--update-baseline"
                print(f"{flag} requires a value", file=sys.stderr)
                raise SystemExit(2)
            return v

        try:
            if a == "--strict":
                strict = True
            elif a == "--list":
                list_rules = True
            elif a == "--no-cache":
                use_cache = False
            elif a == "--dynamic":
                dynamic = True
            elif a == "--update-baseline":
                update_baseline = True
            elif a == "--json" or a.startswith("--json="):
                json_out = value("--json")
            elif a == "--baseline" or a.startswith("--baseline="):
                baseline_path = value("--baseline")
            elif a == "--device" or a.startswith("--device="):
                device = value("--device")
            elif a == "--seeds" or a.startswith("--seeds="):
                try:
                    n_seeds = int(value("--seeds"))
                except ValueError:
                    print("--seeds requires an integer", file=sys.stderr)
                    return 2
                if n_seeds < 1:
                    print("--seeds must be >= 1", file=sys.stderr)
                    return 2
            elif a == "--rules" or a.startswith("--rules="):
                spec = value("--rules")
                rule_ids = [r.strip() for r in spec.split(",")
                            if r.strip()]
            else:
                print(f"unknown analyze option: {a}", file=sys.stderr)
                return 2
        except SystemExit as exc:
            if isinstance(exc.code, int):
                return exc.code
            raise
        i += 1

    if update_baseline and not baseline_path:
        print("--update-baseline requires --baseline <path>",
              file=sys.stderr)
        return 2

    if list_rules:
        for rid in all_rule_ids():
            r = RULES[rid]
            print(f"{rid:18s} [{r.scope}] {r.doc}")
        return 0

    try:
        if use_cache:
            from .cache import cached_package_run
            findings, report = cached_package_run(rule_ids=rule_ids)
        else:
            findings, report = run_rules(load_package_corpus(),
                                         rule_ids=rule_ids)
            report["cached"] = False
    except KeyError as exc:
        print(f"analyze: {exc.args[0]}", file=sys.stderr)
        return 2

    for f in findings:
        print(f.format())
    ran = len(report["rules"])
    cached = " (cached)" if report.get("cached") else ""
    print(f"analyze: {len(findings)} finding(s) from {ran} rule(s) over "
          f"{report['files']} file(s) in {report['duration_ms']:.0f} ms"
          f"{cached}", file=sys.stderr)

    # -- baseline ratchet --------------------------------------------------
    gate_findings = findings
    if baseline_path:
        current = [f.to_dict() for f in findings]
        if update_baseline:
            from ..core.io import atomic_write_text
            atomic_write_text(baseline_path, json.dumps(
                {"findings": current}, indent=2) + "\n")
            print(f"analyze: baseline updated with {len(current)} "
                  f"finding(s) at {baseline_path}", file=sys.stderr)
            gate_findings = []
        else:
            base = _load_baseline(baseline_path)
            if base is None:
                print(f"analyze: no baseline at {baseline_path} "
                      f"(treating every finding as new; write one with "
                      f"--update-baseline)", file=sys.stderr)
                base = []
            # multiset diff: a SECOND identical violation in the same
            # file (several rules emit line-independent messages) must
            # not hide behind one baselined occurrence
            from collections import Counter
            known = Counter(_finding_key(d) for d in base)
            seen: Counter = Counter()
            new = []
            for f in findings:
                k = _finding_key(f.to_dict())
                seen[k] += 1
                if seen[k] > known.get(k, 0):
                    new.append(f)
            resolved = sum((known - seen).values())
            print(f"analyze: baseline ratchet — {len(new)} new, "
                  f"{len(findings) - len(new)} known, "
                  f"{resolved} resolved (baseline has "
                  f"{len(base)})", file=sys.stderr)
            gate_findings = new
            report["baseline"] = {
                "path": baseline_path, "known": len(base),
                "new": len(new), "resolved": resolved}

    # -- dynamic fold-algebra verification ---------------------------------
    dynamic_failed = False
    if dynamic:
        from ..cli import run_mesh
        from ..core.algebra import DEFAULT_SEEDS, run_dynamic
        seeds = (list(DEFAULT_SEEDS) + [101 + 13 * k
                                        for k in range(n_seeds)])[:n_seeds]
        reports = run_dynamic(
            seeds=seeds, log=lambda m: print(m, file=sys.stderr),
            mesh=run_mesh(device))
        failed = [r for r in reports if r.failed]
        dynamic_failed = bool(failed)
        report["dynamic"] = [r.to_dict() for r in reports]
        print(f"analyze: dynamic verification — "
              f"{len(reports) - len(failed)}/{len(reports)} report(s) "
              f"clean", file=sys.stderr)
        for r in failed:
            print(r.format(), file=sys.stderr)

    if json_out:
        write_json_report(json_out, report)
        print(f"analyze: wrote JSON report to {json_out}",
              file=sys.stderr)
    if dynamic_failed:
        return 1
    if strict and gate_findings:
        return 1
    return 0
