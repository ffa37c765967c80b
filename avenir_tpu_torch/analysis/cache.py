"""Incremental analyze: per-file parse cache + whole-run report cache.

The port's copy of ``avenir_tpu/analysis/cache.py``, with a sidecar of
its own, ``.avenir-analyze-torch/`` beside the package: the reference's
``.avenir-analyze/`` holds the reference's own reports, and two packages
writing one directory would replay each other's findings.

- **parse cache** (``corpus.pkl``): every parsed tree keyed by the
  file's rel path with its FULL TEXT compared on load (files are still
  read each run — only the ``ast.parse`` is skipped, which is where the
  time goes; the pickle round-trips ``ast`` trees exactly).
- **report cache** (``report-<rules>.json``): when the corpus digest
  (every file's sha1 + the README's + the cache/interpreter version)
  matches the stored run for the same rule selection, the previous
  findings are replayed without running any rule — correct because
  every rule input (sources, registries, rule code itself) lives
  inside the digested corpus.

Any change to any ``.py`` under the package (or the README) changes the
digest, so invalidation is automatic.  Both sidecar writes are atomic
(``core.io.atomic_write_text``/``atomic_write_bytes``); a torn or
unreadable sidecar silently degrades to a cold run.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import sys
from typing import List, Optional, Sequence, Tuple

from .engine import Corpus, Finding, package_root, run_rules

#: bump on cache-format changes; the interpreter version rides along so
#: a Python upgrade (whose ast node shapes and parser may differ) never
#: replays trees or findings pickled under the old runtime
CACHE_VERSION = "1-py{}.{}.{}".format(*sys.version_info[:3])
CACHE_DIR_NAME = ".avenir-analyze-torch"


def default_cache_dir() -> str:
    """The repo-level sidecar dir: next to the package (the directory
    holding ``avenir_tpu_torch/`` and README.md)."""
    return os.path.join(os.path.dirname(package_root()), CACHE_DIR_NAME)


def _sha1(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()


class AnalysisCache:
    """One cache directory's load/store surface.  ``stats`` records
    what the last :meth:`run` reused (reparsed file count, report
    hit/miss) so tests — and curious operators — can see the warm path
    actually engage."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.dir = cache_dir or default_cache_dir()
        self.stats = {"parsed": None, "reused": None, "report_hit": False}

    # -- parse cache -------------------------------------------------------
    def _corpus_pkl(self) -> str:
        return os.path.join(self.dir, "corpus.pkl")

    def _load_parse_cache(self) -> dict:
        try:
            with open(self._corpus_pkl(), "rb") as fh:
                payload = pickle.load(fh)
            if payload.get("version") == CACHE_VERSION:
                return payload.get("files", {})
        except (OSError, pickle.PickleError, EOFError, AttributeError,
                ValueError):
            pass                    # torn/stale sidecar: cold parse
        return {}

    def load_corpus(self, root: str,
                    readme_path: Optional[str] = None) -> Corpus:
        """Corpus over ``root`` reusing every cached unchanged parse;
        refreshes the sidecar when anything was (re)parsed."""
        from ..core.io import atomic_write_bytes

        cached = self._load_parse_cache()
        corpus = Corpus(root, readme_path=readme_path,
                        parse_cache=cached)
        self.stats["parsed"] = corpus.parsed_files
        self.stats["reused"] = len(corpus.files) - corpus.parsed_files
        fresh = {rel: (sf.text, sf.tree)
                 for rel, sf in corpus.items()}
        if corpus.parsed_files or set(fresh) != set(cached):
            try:
                atomic_write_bytes(self._corpus_pkl(), pickle.dumps(
                    {"version": CACHE_VERSION, "files": fresh},
                    protocol=pickle.HIGHEST_PROTOCOL))
            except OSError:
                pass                # unwritable cache dir: still correct
        return corpus

    # -- report cache ------------------------------------------------------
    @staticmethod
    def _digest_entries(entries, readme_text: str) -> str:
        """ONE digest definition for both paths: sorted (rel, text)
        pairs + the readme — corpus_digest and tree_digest MUST agree
        for the same tree or the two callers would thrash each other's
        report sidecars."""
        h = hashlib.sha1()
        h.update(f"v{CACHE_VERSION}".encode())
        for rel, text in sorted(entries):
            h.update(rel.encode())
            h.update(_sha1(text.encode()).encode())
        h.update(_sha1(readme_text.encode()).encode())
        return h.hexdigest()

    def corpus_digest(self, corpus: Corpus) -> str:
        return self._digest_entries(
            ((rel, sf.text) for rel, sf in corpus.items()),
            corpus.readme)

    def tree_digest(self, root: str,
                    readme_path: Optional[str] = None) -> str:
        """The identical digest straight from the files — no parse, no
        unpickle: the warm path's first (and usually only) work.
        Equality with :meth:`corpus_digest` is asserted in tests."""
        entries = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path) as fh:
                    entries.append((rel, fh.read()))
        readme = ""
        if readme_path and os.path.exists(readme_path):
            with open(readme_path) as fh:
                readme = fh.read()
        return self._digest_entries(entries, readme)

    def load_report(self, digest: str,
                    rule_ids: Optional[Sequence[str]] = None
                    ) -> Optional[Tuple[List[Finding], dict]]:
        """The stored (findings, report) for this digest + rule
        selection, or None on miss/torn sidecar."""
        import time

        t0 = time.monotonic()
        try:
            with open(self._report_path(rule_ids)) as fh:
                stored = json.load(fh)
            if stored.get("digest") != digest:
                return None
            report = stored["report"]
        except (OSError, ValueError, KeyError, TypeError):
            return None
        report["cached"] = True
        report["cold_duration_ms"] = report.get("duration_ms")
        report["duration_ms"] = round((time.monotonic() - t0) * 1e3, 2)
        self.stats["report_hit"] = True
        findings = [Finding(**d) for d in report.get("findings", [])]
        return findings, report

    def store_report(self, digest: str, report: dict,
                     rule_ids: Optional[Sequence[str]] = None) -> None:
        from ..core.io import atomic_write_text

        try:
            atomic_write_text(self._report_path(rule_ids), json.dumps(
                {"digest": digest, "report": report}) + "\n")
        except OSError:
            pass

    def _report_path(self, rule_ids: Optional[Sequence[str]]) -> str:
        key = _sha1(",".join(sorted(rule_ids)).encode())[:12] \
            if rule_ids else "all"
        return os.path.join(self.dir, f"report-{key}.json")

    def run(self, corpus: Corpus,
            rule_ids: Optional[Sequence[str]] = None,
            use_cache: bool = True
            ) -> Tuple[List[Finding], dict]:
        """``run_rules`` with the report cache in front: a digest hit
        replays the stored findings (``report["cached"] = True``)
        without executing a single rule."""
        digest = self.corpus_digest(corpus)
        self.stats["report_hit"] = False
        if use_cache:
            hit = self.load_report(digest, rule_ids)
            if hit is not None:
                return hit
        findings, report = run_rules(corpus, rule_ids=rule_ids)
        report["cached"] = False
        self.store_report(digest, report, rule_ids)
        return findings, report


def cached_package_run(rule_ids: Optional[Sequence[str]] = None,
                       use_cache: bool = True,
                       cache_dir: Optional[str] = None
                       ) -> Tuple[List[Finding], dict]:
    """The CLI's default path: the package corpus through the cache
    (parse reuse + report replay)."""
    pkg = package_root()
    readme = os.path.join(os.path.dirname(pkg), "README.md")
    cache = AnalysisCache(cache_dir)
    if use_cache:
        # report-first: a digest hit replays findings WITHOUT building
        # (or unpickling) any corpus — the sub-second warm path
        digest = cache.tree_digest(pkg, readme_path=readme)
        hit = cache.load_report(digest, rule_ids)
        if hit is not None:
            findings, report = hit
            cache.stats["parsed"] = 0
            report["cache_stats"] = dict(cache.stats)
            return findings, report
        corpus = cache.load_corpus(pkg, readme_path=readme)
        findings, report = run_rules(corpus, rule_ids=rule_ids)
        report["cached"] = False
        cache.store_report(digest, report, rule_ids)
    else:
        corpus = Corpus(pkg, readme_path=readme)
        findings, report = run_rules(corpus, rule_ids=rule_ids)
        report["cached"] = False
    report["cache_stats"] = dict(cache.stats)
    return findings, report
