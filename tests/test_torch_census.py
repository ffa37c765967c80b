"""The census: the port does all that the JAX package does.

Read from source with ``ast`` (neither package is imported), every module
of ``avenir_tpu/`` is held against its mirror in ``avenir_tpu_torch/``:

- every public top-level name (function, class, constant; in a package's
  ``__init__.py`` also the names it re-exports from its modules) and
  every public method of a public class must exist in the mirrored
  module, or stand in :data:`CENSUS_EXCLUDED` with its counterpart in the
  port or the written reason it has none;
- the reference CLI's subcommands, its ``JOBS`` table and the fault
  points of ``core/faultinject.py::POINTS`` must equal the port's.

A reference name added later, or a counterpart renamed, fails here.
"""

import ast
import functools
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "avenir_tpu")
PORT = os.path.join(REPO, "avenir_tpu_torch")

#: reference module -> the port's module, where it is not the same path
_RENAMED = {
    "analysis/rules_jax.py": "analysis/rules_torch.py",
    "ops/pallas_count.py": "ops/histogram.py",
    "ops/pallas_topk.py": "ops/topk.py",
}

_MXU = ("the reference's one-hot MXU counting route, taken only on a TPU "
        "(avenir_tpu/ops/counting.py:38-49, models/tree.py:113-141); the "
        "port counts with K1 and index_add_, which equal both of its "
        "branches")

_ONE_ENCODE = ("the knobs of the reference's pthread fan-out of its native "
               "encode over buffers of 4 MB or more; the port has one "
               "encode, chunk_encode, on the calling thread, and spreads a "
               "parse over threads only through ingest.parse.threads "
               "(native/__init__.py)")

#: ``reference module::name`` -> its counterpart in the port
#: (``module.py::name``) or the reason the port has none.  Excluding a
#: class excludes its methods.
CENSUS_EXCLUDED = {
    "__init__.py::enable_x64":
        "a JAX mechanism (jax_enable_x64): torch dtypes are explicit, and "
        "the port computes in float64 and int64 wherever the reference "
        "does under x64",
    "analysis/rules_jax.py::BARE_JIT_MODULES":
        "analysis/rules_torch.py::BARE_CAPTURE_MODULES",
    "analysis/rules_jax.py::jax_bare_jit_findings":
        "analysis/rules_torch.py::torch_bare_capture_findings",
    "analysis/rules_jax.py::jax_hot_path_findings":
        "analysis/rules_torch.py::torch_hot_path_findings",
    "core/pipeline.py::HostStager":
        "it guards host buffers against XLA's zero-copy aliasing of a "
        "device_put; the port's ChunkTransfer reuses a pinned slot only "
        "after the CUDA event of its last copy (core/pipeline.py:40-45)",
    "core/pipeline.py::clear_fold_cache":
        "it empties the reference's memo of jitted fold pairs; the port "
        "compiles no fold, so it keeps no such memo (core/pipeline.py:40-45)",
    "core/telemetry.py::profiled_jit": "core/telemetry.py::profiled_build",
    "native/__init__.py::MT_MIN_BYTES": _ONE_ENCODE,
    "native/__init__.py::MT_THREADS": _ONE_ENCODE,
    "ops/counting.py::count_on_mxu": _MXU,
    "ops/counting.py::masked_onehot": _MXU,
    "ops/counting.py::onehot_dtype": _MXU,
    "ops/pallas_count.py::wide_count_applicable":
        "ops/histogram.py::histogram_plan",
    "ops/pallas_topk.py::select_and_check": "ops/topk.py::segment_keys",
    "parallel/mesh.py::shard_map":
        "a JAX mechanism (jax's shard_map across its versions); the port "
        "drives each mesh position in turn from one process "
        "(parallel/mesh.py)",
}

_COUNTERPART = re.compile(r"^[\w/]+\.py::[A-Za-z_]\w*(\.[A-Za-z_]\w*)?$")


def mirror(rel: str) -> str:
    if rel.startswith("datagen/"):
        return "datagen.py"
    return _RENAMED.get(rel, rel)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _top_statements(tree: ast.Module):
    """The module's top-level statements, with the bodies of top-level
    ``if``/``try`` blocks (a name defined on either branch)."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, ast.If):
            todo[:0] = node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo[:0] = (node.body + node.orelse + node.finalbody
                        + [s for h in node.handlers for s in h.body])
        else:
            yield node


def _targets(node):
    if isinstance(node, ast.Assign):
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    yield n.id
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                         ast.Name):
        yield node.target.id


@functools.lru_cache(maxsize=None)
def _tree(path: str) -> ast.Module:
    with open(path, encoding="utf-8") as fh:
        return ast.parse(fh.read(), filename=path)


@functools.lru_cache(maxsize=None)
def reference_names(rel: str) -> frozenset:
    """What the reference module offers: public top-level names and the
    public methods of public classes (``Class.method``); a package's
    ``__init__.py`` also offers what it imports from its own modules."""
    out = set()
    package = rel.endswith("__init__.py")
    for node in _top_statements(_tree(os.path.join(REF, rel))):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            out.update(f"{node.name}.{b.name}" for b in node.body
                       if isinstance(b, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and _public(b.name))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
        elif (package and isinstance(node, ast.ImportFrom) and node.level
              and node.module):
            out.update(a.asname or a.name for a in node.names)
    return frozenset(n for n in out if _public(n.split(".")[0])
                     and n != "*")


@functools.lru_cache(maxsize=None)
def port_names(rel: str) -> frozenset:
    """Every name the port's module binds: definitions, constants,
    imports, class members (``Class.member``), a literal ``__all__``, and
    the keys of a module-level table that a PEP 562 ``__getattr__``
    resolves on first use."""
    out, tables, lazy = set(), [], False
    for node in _top_statements(_tree(os.path.join(PORT, rel))):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
            lazy |= node.name == "__getattr__"
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{b.name}")
                out.update(f"{node.name}.{t}" for t in _targets(b))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names = set(_targets(node))
            out |= names
            if isinstance(node.value, (ast.List, ast.Tuple)) and \
                    "__all__" in names:
                out.update(e.value for e in node.value.elts
                           if isinstance(e, ast.Constant))
            if isinstance(node.value, ast.Dict):
                tables.append(node.value)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    if lazy:
        out.update(k.value for t in tables for k in t.keys
                   if isinstance(k, ast.Constant))
    return frozenset(out)


def _reference_modules():
    mods = []
    for root, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(root, f), REF)
                            .replace(os.sep, "/"))
    return sorted(mods)


REFERENCE_MODULES = _reference_modules()


def _excluded(rel: str, name: str) -> bool:
    return (f"{rel}::{name}" in CENSUS_EXCLUDED
            or f"{rel}::{name.split('.')[0]}" in CENSUS_EXCLUDED)


@pytest.mark.parametrize("rel", REFERENCE_MODULES)
def test_every_reference_name_has_a_counterpart(rel):
    """Each public name of the reference module exists in its mirror in
    the port, or stands in CENSUS_EXCLUDED."""
    mirrored = mirror(rel)
    assert os.path.isfile(os.path.join(PORT, mirrored)), (
        f"avenir_tpu/{rel} has no mirror: avenir_tpu_torch/{mirrored} is "
        f"missing")
    have = port_names(mirrored)
    missing = sorted(n for n in reference_names(rel)
                     if n not in have and not _excluded(rel, n))
    assert not missing, (
        f"avenir_tpu/{rel} names {missing}, which "
        f"avenir_tpu_torch/{mirrored} lacks: port them, or add each to "
        f"CENSUS_EXCLUDED with its counterpart or the reason it has none")


@pytest.mark.parametrize("entry", sorted(CENSUS_EXCLUDED))
def test_excluded_entry_is_live(entry):
    """An entry names a reference name that still exists and that the
    port still lacks, and gives a counterpart that exists or a reason."""
    rel, name = entry.split("::")
    assert rel in REFERENCE_MODULES, f"{entry}: no module avenir_tpu/{rel}"
    assert name in reference_names(rel), (
        f"{entry}: avenir_tpu/{rel} no longer names {name}; drop the entry")
    assert name not in port_names(mirror(rel)), (
        f"{entry}: the port now has {name}; drop the entry")
    why = CENSUS_EXCLUDED[entry].strip()
    if _COUNTERPART.match(why):
        mod, counterpart = why.split("::")
        assert os.path.isfile(os.path.join(PORT, mod)), (
            f"{entry}: counterpart module avenir_tpu_torch/{mod} is missing")
        assert counterpart in port_names(mod), (
            f"{entry}: avenir_tpu_torch/{mod} has no {counterpart}")
    else:
        assert len(why.split()) >= 5, f"{entry}: give a written reason"


def _subcommands(path: str) -> set:
    """The names ``main`` dispatches on: ``job_name == "x"`` and
    ``job_name in ("x", "y")``."""
    out = set()
    for node in ast.walk(_tree(path)):
        if not (isinstance(node, ast.Compare)
                and isinstance(node.left, ast.Name)
                and node.left.id == "job_name"):
            continue
        for op, cmp in zip(node.ops, node.comparators):
            if isinstance(op, ast.Eq) and isinstance(cmp, ast.Constant):
                out.add(cmp.value)
            elif isinstance(op, ast.In) and isinstance(
                    cmp, (ast.Tuple, ast.List, ast.Set)):
                out.update(e.value for e in cmp.elts
                           if isinstance(e, ast.Constant))
    return out


def _literal(path: str, name: str):
    for node in _top_statements(_tree(path)):
        if name in set(_targets(node)):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} assigns no {name}")


def test_cli_subcommands_are_the_references():
    want = _subcommands(os.path.join(REF, "cli.py"))
    assert want >= {"serve", "multi", "dag", "stream", "workload",
                    "fleetobs", "router", "analyze"}
    assert _subcommands(os.path.join(PORT, "cli.py")) == want


@pytest.mark.parametrize("rel,table", [("cli.py", "JOBS"),
                                       ("core/faultinject.py", "POINTS")])
def test_jobs_and_fault_points_are_the_references(rel, table):
    want = _literal(os.path.join(REF, rel), table)
    got = _literal(os.path.join(PORT, rel), table)
    if isinstance(want, dict):
        want, got = set(want), set(got)
    assert want and got == want
