"""The port's analyzer run over the port's own package, on the CPU.

The whole catalog runs once over ``load_package_corpus()`` (a
module-scoped fixture) and must report nothing.  Beside it: the checks of
the reference's four coverage shims (``tests/test_*_coverage.py``) over
the port's ``cli.JOBS``, fold specs and README keys; a liveness check of
every site table the rules read (a table that names nothing in the port
would turn its rule off without a word); the ``--dynamic`` leg on the
CPU; and the fault the strict run found (F7: the ``nvcc`` start ran
outside the retry layer).
"""

import json
import os
import re
import subprocess

import pytest

from avenir_tpu_torch.analysis import (RULES, cache as p_cache,
                                       cli as p_cli, load_package_corpus,
                                       run_rules)
from avenir_tpu_torch.analysis import (registries, rules_algebra,
                                       rules_config, rules_io, rules_serve,
                                       rules_torch)
from avenir_tpu_torch.analysis.rules_drivers import (
    RETURN_ALLOWED, _driver_classes, dag_builtin_findings,
    foldspec_dag_findings, foldspec_fusable_findings)


@pytest.fixture(scope="module")
def corpus():
    return load_package_corpus()


@pytest.fixture(scope="module")
def catalog(corpus):
    """The whole catalog over the port's package, run once."""
    return run_rules(corpus)


# ---------------------------------------------------------------------------
# the port is strict-clean
# ---------------------------------------------------------------------------

def test_port_is_clean_under_the_whole_catalog(catalog):
    findings, report = catalog
    assert findings == [], [f.format() for f in findings]
    assert {r["rule"] for r in report["rules"]} == set(RULES)
    assert len(RULES) == 17
    assert report["files"] > 50
    assert report["root"].endswith("avenir_tpu_torch")


@pytest.mark.parametrize("rule_id", sorted(RULES))
def test_rule_reports_nothing_on_the_port(catalog, rule_id):
    _findings, report = catalog
    got = [r for r in report["rules"] if r["rule"] == rule_id]
    assert len(got) == 1 and got[0]["findings"] == 0, got


def test_strict_cli_exits_0_with_a_clean_json_report(tmp_path, corpus):
    """The gate itself, on the corpus the catalog fixture parsed (the
    process-wide ``load_package_corpus``), so the file parses once."""
    out = str(tmp_path / "findings.json")
    assert p_cli.analyze_main(["--strict", "--no-cache", "--json", out]) == 0
    data = json.loads(open(out).read())
    assert data["total_findings"] == 0 and data["findings"] == []
    assert len(data["rules"]) == 17


def test_dynamic_leg_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(p_cache, "default_cache_dir",
                        lambda: str(tmp_path / "sidecar"))
    assert p_cli.analyze_main(["--dynamic", "--device", "cpu", "--seeds",
                               "1", "--rules", "fold-purity"]) == 0
    err = capsys.readouterr().err
    m = re.search(r"dynamic verification — (\d+)/(\d+) report\(s\) clean",
                  err)
    assert m and m.group(1) == m.group(2) and int(m.group(2)) >= 9, err


# ---------------------------------------------------------------------------
# the reference's coverage shims, over the port
# ---------------------------------------------------------------------------

def test_driver_registry_is_the_ports_jobs():
    from avenir_tpu_torch.cli import JOBS
    classes = dict(_driver_classes())
    assert set(classes) == set(JOBS) and len(JOBS) == 39
    for fqcn, cls in classes.items():
        assert cls.__module__.startswith("avenir_tpu_torch.models."), fqcn
    for fqcn in RETURN_ALLOWED:
        assert fqcn in JOBS


@pytest.mark.parametrize("fn", [foldspec_fusable_findings,
                                foldspec_dag_findings],
                         ids=["foldspec-fusable", "foldspec-dag"])
def test_foldspec_registries_live_and_reasoned(fn):
    assert [f.format() for f in fn()] == []


def test_dag_builtins_and_template_keys(corpus):
    assert [f.format() for f in dag_builtin_findings(corpus)] == []


@pytest.mark.parametrize("group", sorted(rules_config.NAMESPACE_GROUPS))
def test_config_key_group_is_live_and_documented(corpus, group):
    prefixes = rules_config.NAMESPACE_GROUPS[group]
    keys = rules_config.collect_config_keys(corpus, prefixes)
    assert keys, f"no {group} config keys found in the port"
    bad = rules_config.config_key_findings(corpus, prefixes)
    assert [f.format() for f in bad] == []
    assert [k for k in sorted(keys) if k not in corpus.readme] == []


def test_durability_keys_are_visible_to_the_rule(corpus):
    keys = rules_config.collect_config_keys(
        corpus, rules_config.NAMESPACE_GROUPS["durability"])
    for expected in ("checkpoint.keep", "checkpoint.fallback",
                     "io.require.success", "serve.poison.isolate",
                     "serve.poison.quarantine.threshold",
                     "serve.poison.cache.size"):
        assert expected in keys, expected


def test_retry_wrappers_exist(corpus):
    """The load-bearing ingest reads and builds really are wrapped (a
    refactor that stops calling with_retries anywhere fails here)."""
    _sites, wrapped = rules_io.scan_ingest_io(corpus)
    for key in ("native/__init__.py:_read_part", "native/__init__.py:_cc_run",
                "core/pipeline.py:_open_text", "ops/_build.py:_nvcc_start"):
        assert key in wrapped, key


def test_atomic_publish_layer_really_writes(corpus):
    sites = rules_io.scan_truncate_writes(corpus)
    assert any(k.startswith("core/io.py:OutputWriter.") for k in sites)
    assert any(k.startswith("core/io.py:atomic_write_text") for k in sites)


def test_fusable_jobs_fold_specs_construct():
    """The port's fold_spec exports build a FoldSpec against a minimal
    config, and text-mode NB declines (the reference's shim, on the
    port's jobs)."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.multiscan import FoldSpec
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import BayesianDistribution
    from avenir_tpu_torch.models.correlation import (
        CramerCorrelation, HeterogeneityReductionCorrelation)
    from avenir_tpu_torch.models.discriminant import NumericalAttrStats
    from avenir_tpu_torch.models.markov import MarkovStateTransitionModel
    from avenir_tpu_torch.models.mutual_info import MutualInformation

    schema = FeatureSchema.from_json(json.dumps({"fields": [
        {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
        {"name": "c", "ordinal": 1, "dataType": "categorical",
         "feature": True, "cardinality": ["a", "b"]},
        {"name": "v", "ordinal": 2, "dataType": "int", "feature": True,
         "min": 0, "max": 10, "bucketWidth": 2},
        {"name": "y", "ordinal": 3, "dataType": "categorical",
         "cardinality": ["N", "Y"]}]}))
    corr = {"source.attributes": "1", "dest.attributes": "3"}
    jobs = [
        BayesianDistribution(JobConfig({}), schema=schema, device="cpu"),
        MutualInformation(JobConfig({}), schema=schema, device="cpu"),
        CramerCorrelation(JobConfig(corr), schema=schema, device="cpu"),
        HeterogeneityReductionCorrelation(JobConfig(corr), schema=schema,
                                          device="cpu"),
        MarkovStateTransitionModel(JobConfig({"model.states": "A,B"}),
                                   device="cpu"),
        NumericalAttrStats(JobConfig({"attr.list": "2"}), device="cpu"),
    ]
    for job in jobs:
        assert isinstance(job.fold_spec("/tmp/out"), FoldSpec), \
            type(job).__name__
    nb_text = BayesianDistribution(JobConfig({"tabular.input": "false"}),
                                   device="cpu")
    assert nb_text.fold_spec("/tmp/out") is None


# ---------------------------------------------------------------------------
# every site table names live sites in the port
# ---------------------------------------------------------------------------

def _prefix_rows(table):
    return [(rel, p) for rel, ps in sorted(table.items()) for p in ps]


_SCOPE_TABLES = {
    "HOT_PATHS": rules_torch.HOT_PATHS,
    "PIPELINE_FOLD_ROOTS": rules_algebra.PIPELINE_FOLD_ROOTS,
    "CARRY_ROOTS": rules_algebra.CARRY_ROOTS,
}
_SCOPE_ROWS = [(name, rel, p) for name, table in sorted(_SCOPE_TABLES.items())
               for rel, p in _prefix_rows(table)]


@pytest.mark.parametrize("row", _SCOPE_ROWS,
                         ids=[f"{n}:{r}:{p}" for n, r, p in _SCOPE_ROWS])
def test_scope_table_entry_names_a_live_scope(corpus, row):
    _name, rel, prefix = row
    assert corpus.get(rel) is not None, rel
    assert corpus.dataflow().expand_prefixes(rel, (prefix,)), \
        f"{rel}:{prefix} names no function or class in the port"


@pytest.mark.parametrize("rel", rules_io.INGEST_MODULES)
def test_ingest_module_exists(corpus, rel):
    assert corpus.get(rel) is not None, rel


@pytest.mark.parametrize("what", sorted(rules_serve.ANOMALY_SITES))
def test_anomaly_site_locator_matches(corpus, what):
    rel, pattern = rules_serve.ANOMALY_SITES[what]
    sf = corpus.get(rel)
    assert sf is not None and re.search(pattern, sf.text), (rel, pattern)


def test_atomic_primitives_and_capture_modules_exist(corpus):
    for prefix in rules_io.ATOMIC_PRIMITIVES:
        rel, _, qual = prefix.partition(":")
        assert corpus.dataflow().expand_prefixes(rel, (qual.rstrip("."),))
    for mod in rules_torch.BARE_CAPTURE_MODULES:
        assert any(rel == mod or (mod.endswith("/") and rel.startswith(mod))
                   for rel in corpus.files), mod


def test_graph_captured_functions_are_hot_paths(corpus):
    """Every function the port hands to GraphedCall is on HOT_PATHS: the
    captured scorer of the NB server and the stream tier's decides."""
    hp = rules_torch.HOT_PATHS
    for rel, qual in (("models/bayesian.py", "BayesianPredictor._score_batch"),
                      ("models/bayesian.py",
                       "BayesianPredictor._score_prepared_f32"),
                      ("stream/posterior.py", "PosteriorStore._decide_fn.ucb"),
                      ("stream/posterior.py",
                       "PosteriorStore._decide_fn.thompson"),
                      ("stream/posterior.py", "_thompson_decide")):
        assert corpus.dataflow().function(rel, qual) is not None, qual
        assert rules_torch._in_hot_path(rel, qual, hp), qual
    graphed = [rel for rel, sf in corpus.items()
               if "GraphedCall(" in sf.text
               and not rel.startswith(("utils/graphs.py", "analysis/"))]
    assert sorted(graphed) == ["serve/engine.py", "stream/posterior.py"]


@pytest.mark.parametrize("name", ["SHARED_UNLOCKED", "HOST_SYNC_ALLOWED",
                                  "FOLD_IMPURE_ALLOWED", "MERGE_EXEMPT",
                                  "HOST_TOPOLOGY_ALLOWED"])
def test_registry_entries_name_port_sites_with_reasons(corpus, name):
    entries = getattr(registries, name)
    for key, reason in entries.items():
        assert reason.strip(), key
        rel = key.split(":", 1)[0]
        if rel.endswith(".py"):
            assert corpus.get(rel) is not None, key


def test_core_registries_exist_with_reasons():
    from avenir_tpu_torch.core.dag import NON_DAG_STAGES
    from avenir_tpu_torch.core.io import NON_ATOMIC_WRITES
    from avenir_tpu_torch.core.multiscan import NON_FUSABLE
    from avenir_tpu_torch.core.resilience import NON_RETRYABLE
    assert NON_RETRYABLE and NON_ATOMIC_WRITES and NON_FUSABLE
    assert NON_DAG_STAGES == {}
    for reg in (NON_RETRYABLE, NON_ATOMIC_WRITES, NON_FUSABLE):
        assert all(r.strip() for r in reg.values())


# ---------------------------------------------------------------------------
# F7: the nvcc start ran outside the retry layer
# ---------------------------------------------------------------------------

def test_nvcc_start_retries_a_transient_failure(tmp_path, monkeypatch):
    """ops/_build.py started nvcc with a bare subprocess.Popen, so a
    transient failure to start the process (EAGAIN) failed the job, where
    the native C library's compile backs off and tries again.  The first
    start fails transiently here; the build must retry and finish."""
    from avenir_tpu_torch.core import resilience
    from avenir_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(resilience, "_POLICY", resilience.RetryPolicy(
        max_attempts=3, base_ms=0.0, max_ms=0.0, jitter=0.0))
    calls = []

    class _Done:
        returncode = 0

        def __init__(self, cmd):
            out = cmd[cmd.index("-o") + 1]
            with open(out, "wb") as fh:
                fh.write(b"built")

        def communicate(self):
            return "", None

    def popen(cmd, **kw):
        calls.append(cmd)
        if len(calls) == 1:
            raise BlockingIOError(11, "Resource temporarily unavailable")
        return _Done(cmd)

    monkeypatch.setattr(subprocess, "Popen", popen)
    before = resilience.retry_counters().get("Retry",
                                             "attempts.cuda.compile")
    _build.build(["histogram"])
    assert len(calls) == 2
    assert os.path.exists(_build.library_path("histogram"))
    assert resilience.retry_counters().get(
        "Retry", "attempts.cuda.compile") == before + 1
