"""Text I/O: the port's copy of the parts of ``avenir_tpu/core/io.py`` the
ported jobs and the server use.

Delimited records come in from a file or from every part file of a job
output directory (non-hidden files, sorted); job output goes out as
``<out>/part-r-00000`` plus a ``_SUCCESS`` marker.  The part file is
written to a temporary file in the same directory and published with
``fsync`` and ``os.replace``, so a crash never leaves a torn file under
the final name.  Every output directory also gets the reference's
``_MANIFEST`` sidecar (per-part byte length and sha1).

A directory input is validated on read (``_input_files``), as the
reference does: with ``io.require.success=true``
(:func:`configure_from_config`) a directory without ``_SUCCESS`` is
refused, and a part whose size or sha1 disagrees with the ``_MANIFEST``
raises :class:`TornArtifactError`.  Recovery and validation events count
in the ``Durability`` group of the process-global telemetry registry.

While an :class:`ArtifactStore` is installed (the workflow DAG's
in-memory handoff, core.dag), ``write_output`` to a registered path also
keeps the lines in memory and ``read_lines`` of that path serves them
from there.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

KEY_REQUIRE_SUCCESS = "io.require.success"

SUCCESS_NAME = "_SUCCESS"
MANIFEST_NAME = "_MANIFEST"
MANIFEST_VERSION = 1


class TornArtifactError(RuntimeError):
    """An artifact directory failed validation: a part whose size or sha1
    disagrees with the ``_MANIFEST``, a part the manifest does not list,
    a listed part that is gone, or (with ``io.require.success``) a
    missing ``_SUCCESS`` marker.  Every construction marks the flight
    recorder's ring (core.flight), as the reference's does."""

    def __init__(self, *args):
        super().__init__(*args)
        from . import flight
        try:
            flight.trigger("torn_artifact", detail=str(self))
        except Exception:                               # noqa: BLE001
            pass        # the black box must never mask the real error


#: truncate-mode write sites (``module.py:qualname``) that deliberately
#: do NOT go through the atomic publish layer (``OutputWriter`` /
#: ``atomic_write_text`` / ``atomic_write_bytes``), each with the reason
#: the torn-on-crash shape is acceptable there.  The ``io-atomic-write``
#: rule (``analysis/rules_io.py``) fails on any ``open(..., "w")`` outside
#: the atomic primitives that is not listed, and on a stale entry.
NON_ATOMIC_WRITES: Dict[str, str] = {
    "core/checkpoint.py:StreamCheckpointer.save":
        "atomic by construction: pickles into a same-directory mkstemp "
        "file and lands it with os.replace (a binary payload, which "
        "atomic_write_text's text surface does not take); a crash "
        "mid-save leaves the previous generation whole",
    "core/checkpoint.py:WorkflowCheckpointer.record":
        "atomic by construction, the same temp + os.replace shape as "
        "StreamCheckpointer.save",
    "core/checkpoint.py:OffsetCheckpointer.save":
        "atomic by construction, the same temp + os.replace shape as "
        "StreamCheckpointer.save (the stream-offset sidecar)",
    "core/obs.py:Tracer.export_jsonl":
        "a diagnostic trace export, not a job artifact: no reader "
        "validates it, and re-running with --trace remakes it",
    "core/obs.py:Tracer.export_chrome_trace":
        "a diagnostic trace export, the same contract as export_jsonl",
    "core/resilience.py:RowQuarantine._write":
        "the quarantine audit sidecar: the first open truncates a stale "
        "sidecar of an earlier run, later batches append; an audit "
        "trail, not a consumed artifact",
    "datagen.py:main":
        "the seeded dataset generator (input-side tooling): generating "
        "again is the recovery, and the ingest layer validates inputs",
    "runbook.py:_edit_file":
        "rewrites a runbook script inside its scratch copy, which every "
        "run makes afresh from the repo's source; nothing else reads it",
    "runbook.py:port_runbook":
        "writes the rewritten run.sh/run.py into the same scratch copy "
        "as _edit_file, made afresh on every run",
}

_REQUIRE_SUCCESS = False


def set_require_success(flag: bool) -> bool:
    """Install the strict ``_SUCCESS``-marker mode for directory inputs;
    returns the previous setting so callers can restore it."""
    global _REQUIRE_SUCCESS
    prev = _REQUIRE_SUCCESS
    _REQUIRE_SUCCESS = bool(flag)
    return prev


def configure_from_config(config) -> None:
    """Apply the ``io.*`` config surface (the CLI entry points call it
    next to the resilience configure)."""
    set_require_success(config.get_boolean(KEY_REQUIRE_SUCCESS, False))


def _durability_counters():
    """The process-global ``Durability`` counter group (it rides the
    telemetry registry, so ``--metrics-out`` exports recovery events)."""
    from . import telemetry
    return telemetry.get_metrics().counters


def _input_files(path: str) -> List[str]:
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if not f.startswith(("_", ".")) and os.path.isfile(os.path.join(path, f))
        )
        validate_artifact_dir(path, files)
        return files
    return [path]


class ArtifactStore:
    """In-memory overlay for job-output artifacts (the core.dag handoff).

    While a store is installed (:func:`set_artifact_store`),
    ``write_output`` to a REGISTERED path also records the lines in
    memory, and ``read_lines`` on that path serves them from memory: the
    downstream stage consumes the producer's artifact and the text file
    is a sink, not the transport.  Unregistered paths (quarantine
    sidecars, checkpoints, jobs outside the workflow) never enter it.

    ``verify=True`` checks, on the first memory read of each artifact
    whose file was also written, that the in-memory lines equal the file
    round-trip.  A path registered with ``sink_file=False`` skips the
    file write; its artifact exists only in memory.
    """

    def __init__(self, verify: bool = True):
        self.verify = verify
        self._registered: Dict[str, bool] = {}     # abspath -> sink_file
        self._lines: Dict[str, List[str]] = {}
        self._verified: set = set()
        self.memory_reads = 0

    def register(self, out_path: str, sink_file: bool = True) -> None:
        self._registered[os.path.abspath(out_path)] = sink_file

    def _owner(self, path: str) -> Optional[str]:
        """The registered path governing ``path`` (itself or its
        directory), or None."""
        ap = os.path.abspath(path)
        if ap in self._registered:
            return ap
        parent = os.path.dirname(ap)
        if parent in self._registered:
            return parent
        return None

    def wants(self, out_path: str) -> bool:
        return self._owner(out_path) is not None

    def sink_file(self, out_path: str) -> bool:
        owner = self._owner(out_path)
        return True if owner is None else self._registered[owner]

    def put(self, out_path: str, file_path: str, lines: List[str]) -> None:
        for key in {os.path.abspath(out_path), os.path.abspath(file_path)}:
            self._lines[key] = lines

    def peek(self, path: str) -> Optional[List[str]]:
        """The stored lines for ``path`` without counting a memory read
        or running the parity check (the cost model's size estimate)."""
        return self._lines.get(os.path.abspath(path))

    def get(self, path: str) -> Optional[List[str]]:
        ap = os.path.abspath(path)
        lines = self._lines.get(ap)
        if lines is None:
            return None
        self.memory_reads += 1
        if self.verify and ap not in self._verified:
            if os.path.exists(ap):
                # may raise TornArtifactError; a failed check leaves the
                # artifact unverified, so a later read checks again
                on_disk = list(_read_lines_files(ap))
                if on_disk != lines:
                    raise AssertionError(
                        f"artifact store: in-memory lines for {ap} differ "
                        f"from the file round-trip ({len(lines)} vs "
                        f"{len(on_disk)} lines) — handoff parity broken")
            self._verified.add(ap)
        return lines


_ARTIFACTS: Optional[ArtifactStore] = None


def set_artifact_store(store: Optional[ArtifactStore]
                       ) -> Optional[ArtifactStore]:
    """Install (or clear, with None) the process-global artifact overlay;
    returns the previous store so callers can restore it."""
    global _ARTIFACTS
    prev = _ARTIFACTS
    _ARTIFACTS = store
    return prev


def get_artifact_store() -> Optional[ArtifactStore]:
    return _ARTIFACTS


def _read_lines_files(path: str) -> Iterator[str]:
    for fp in _input_files(path):
        with open(fp, "r") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line:
                    yield line


def read_lines(path: str) -> Iterator[str]:
    """Yield every non-empty record line from a file or job-output
    directory; from the in-memory artifact when an installed
    :class:`ArtifactStore` holds ``path``."""
    store = _ARTIFACTS
    if store is not None:
        lines = store.get(path)
        if lines is not None:
            return iter(lines)
    return _read_lines_files(path)


def is_plain_delim(delim_regex: str) -> bool:
    """True when the delimiter regex is one literal character, the case
    every bulk fast path handles."""
    return len(delim_regex) == 1 and delim_regex not in r".^$*+?{}[]\|()"


def split_line(line: str, delim_regex: str = ",") -> List[str]:
    """Split one record on the configured delimiter regex."""
    if is_plain_delim(delim_regex):
        return line.split(delim_regex)
    return re.split(delim_regex, line)


def read_records(path: str, delim_regex: str = ",") -> Iterator[List[str]]:
    for line in read_lines(path):
        yield split_line(line, delim_regex)


def read_field_matrix(path: str, delim_regex: str = ","):
    """A rectangular delimited input as a 2-D string ndarray made with one
    whole-buffer split; None when the delimiter is a regex or the rows are
    ragged (callers then go through ``read_records``)."""
    if not is_plain_delim(delim_regex):
        return None
    import numpy as np

    lines: List[str] = []
    for fp in _input_files(path):
        with open(fp, "r") as fh:
            lines.extend(l for l in fh.read().split("\n") if l)
    if not lines:
        return np.empty((0, 0), dtype=str)
    n_delim = lines[0].count(delim_regex)
    # every line must have the same field count, or fields would shift
    # across rows
    if any(l.count(delim_regex) != n_delim for l in lines):
        return None
    flat = delim_regex.join(lines).split(delim_regex)
    return np.asarray(flat, dtype=str).reshape(len(lines), n_delim + 1)


def write_output(out_path: str, lines: Iterable[str],
                 shard: Optional[int] = None, as_dir: bool = True) -> str:
    """Write job output as ``<out_path>/part-r-<shard>`` (atomically, with
    the ``_MANIFEST`` and ``_SUCCESS`` of ``OutputWriter``), or as the
    bare file ``out_path`` with ``as_dir=False``; returns the file's
    path.  With an :class:`ArtifactStore` installed and ``out_path``
    registered, the lines are also kept in memory, and a path registered
    with ``sink_file=False`` is not written at all."""
    store = _ARTIFACTS
    if store is not None and store.wants(out_path):
        lines = list(lines)
        file_path = (os.path.join(out_path, f"part-r-{(shard or 0):05d}")
                     if as_dir else out_path)
        store.put(out_path, file_path, lines)
        if not store.sink_file(out_path):
            return file_path
    with OutputWriter(out_path, shard=shard, as_dir=as_dir) as w:
        for line in lines:
            w.write(line)
    return w.file_path


def _sha1_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def load_manifest(dir_path: str) -> Optional[dict]:
    """The directory's ``_MANIFEST`` document, or None when absent; an
    unreadable one is a torn artifact."""
    mpath = os.path.join(dir_path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, "r") as fh:
            doc = json.load(fh)
        if not isinstance(doc.get("parts"), dict):
            raise ValueError("manifest has no parts table")
        return doc
    except (ValueError, OSError) as e:
        _durability_counters().incr("Durability", "Torn artifacts")
        raise TornArtifactError(f"{mpath} is unreadable ({e}): artifact "
                                f"torn; re-run the producing job") from None


#: validation memo: (dir abspath) -> (manifest stat sig, part stat sigs),
#: so repeated reads of an unchanged artifact hash its parts once
_VALIDATED: Dict[str, Tuple] = {}
_VALIDATED_CAP = 256


def _stat_sig(path: str):
    st = os.stat(path)
    return (st.st_size, st.st_mtime_ns)


def _torn(message: str) -> TornArtifactError:
    _durability_counters().incr("Durability", "Torn artifacts")
    return TornArtifactError(message)


def validate_artifact_dir(path: str, files: List[str]) -> None:
    """Durability validation of one directory input: the strict
    ``_SUCCESS`` check (``io.require.success=true``), then, when a
    ``_MANIFEST`` is present, every part in ``files`` against it (byte
    length and sha1) and every listed part still on disk.  Raises
    :class:`TornArtifactError` naming the path and the part."""
    if _REQUIRE_SUCCESS and not os.path.exists(
            os.path.join(path, SUCCESS_NAME)):
        _durability_counters().incr("Durability", "Unmarked inputs refused")
        raise TornArtifactError(
            f"{path}: no {SUCCESS_NAME} marker — the producing job did not "
            f"complete (half-written upstream output?); re-run the "
            f"producer or unset {KEY_REQUIRE_SUCCESS}")
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return
    ap = os.path.abspath(path)
    sig = (_stat_sig(mpath), tuple(_stat_sig(fp) for fp in files))
    if _VALIDATED.get(ap) == sig:
        return
    parts = load_manifest(path)["parts"]
    for fp in files:
        name = os.path.basename(fp)
        rec = parts.get(name)
        if not isinstance(rec, dict):
            raise _torn(f"{path}: part {name} is not in {MANIFEST_NAME}")
        size = os.path.getsize(fp)
        if size != rec.get("bytes"):
            raise _torn(f"{path}: part {name} is {size} bytes but "
                        f"{MANIFEST_NAME} records {rec.get('bytes')}")
        if _sha1_file(fp) != rec.get("sha1"):
            raise _torn(f"{path}: part {name} checksum mismatch against "
                        f"{MANIFEST_NAME}")
    lost = sorted(set(parts) - {os.path.basename(fp) for fp in files})
    if lost:
        raise _torn(f"{path}: {MANIFEST_NAME} records part(s) "
                    f"{', '.join(lost)} that no longer exist")
    if len(_VALIDATED) >= _VALIDATED_CAP:
        _VALIDATED.clear()
    _VALIDATED[ap] = sig
    _durability_counters().incr("Durability", "Artifacts validated")


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a same-directory temporary file,
    ``fsync`` and ``os.replace``: a crash leaves the old file or the new
    one, never a torn one.  Creates the directory when it is missing."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".",
                               dir=d)
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Binary twin of :func:`atomic_write_text`."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".",
                               dir=d)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class OutputWriter:
    """One part file of an artifact directory, written crash-safely: the
    part is staged to a temporary file in the same directory and published
    with ``fsync`` and ``os.replace``, then merged into the directory's
    ``_MANIFEST``, and (with ``mark_success``) the ``_SUCCESS`` marker is
    written.  ``shard`` picks the part number; ``as_dir=False`` writes
    ``out_path`` itself as a bare file (atomic replace, no manifest or
    marker).  ``binary=True`` takes bytes through :meth:`write_bytes`.
    Closing after an exception discards the stage."""

    def __init__(self, out_path: str, name: Optional[str] = None,
                 binary: bool = False, mark_success: bool = True,
                 shard: Optional[int] = None, as_dir: bool = True):
        self.out_path = out_path
        self.as_dir = as_dir
        self.mark_success = mark_success
        if as_dir:
            if name is not None and shard is not None:
                raise ValueError("name and shard are mutually exclusive")
            os.makedirs(out_path, exist_ok=True)
            self.file_path = os.path.join(
                out_path, name or f"part-r-{(shard or 0):05d}")
        else:
            if shard is not None:
                raise ValueError("shard is only meaningful with as_dir=True")
            parent = os.path.dirname(out_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self.file_path = out_path
        d = os.path.dirname(self.file_path) or "."
        fd, self._tmp_path = tempfile.mkstemp(
            prefix="." + os.path.basename(self.file_path) + ".", dir=d)
        self._fh = os.fdopen(fd, "wb" if binary else "w")
        self._binary = binary
        self._closed = False

    def write(self, line: str) -> None:
        if self._binary:
            raise TypeError("binary writer: use write_bytes")
        self._fh.write(line)
        self._fh.write("\n")

    def write_bytes(self, data) -> None:
        if not self._binary:
            raise TypeError("text writer: use write")
        self._fh.write(data)

    def write_all(self, lines: Iterable[str]) -> None:
        for line in lines:
            self.write(line)

    def _tear(self) -> None:
        """The ``torn_write`` fault point: the crash of an in-place writer
        mid-write.  Half the staged bytes land under the final name, with
        no ``_MANIFEST`` update and no ``_SUCCESS``, and the writer dies
        with ``InjectedFault``.  A ``_MANIFEST`` left by an earlier
        publish now disagrees with the part, which is what the readers'
        validation must catch."""
        from .faultinject import InjectedFault
        with open(self._tmp_path, "rb") as fh:
            data = fh.read()
        with open(self.file_path, "wb") as out:
            out.write(data[:max(len(data) // 2, 1)])
        try:
            os.unlink(self._tmp_path)
        except OSError:
            pass
        raise InjectedFault(f"injected torn write ({self.file_path})")

    def _update_manifest(self) -> None:
        mpath = os.path.join(self.out_path, MANIFEST_NAME)
        parts: Dict[str, dict] = {}
        if os.path.exists(mpath):
            try:
                with open(mpath, "r") as fh:
                    doc = json.load(fh)
                if isinstance(doc.get("parts"), dict):
                    parts = doc["parts"]
            except (ValueError, OSError):
                pass        # rewritten from scratch: this part is the truth
        parts[os.path.basename(self.file_path)] = {
            "bytes": os.path.getsize(self.file_path),
            "sha1": _sha1_file(self.file_path)}
        parts = {n: rec for n, rec in parts.items()
                 if os.path.exists(os.path.join(self.out_path, n))}
        atomic_write_text(mpath, json.dumps(
            {"version": MANIFEST_VERSION, "parts": parts}, indent=1))

    def close(self, success_marker: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self._fh.flush()
        if success_marker:
            os.fsync(self._fh.fileno())
        self._fh.close()
        if not success_marker:
            try:
                os.unlink(self._tmp_path)
            except OSError:
                pass
            return
        from .faultinject import get_injector
        fi = get_injector()
        if fi is not None and fi.armed("torn_write") is not None:
            self._tear()
        os.replace(self._tmp_path, self.file_path)
        _VALIDATED.pop(os.path.abspath(self.out_path), None)
        if self.as_dir:
            self._update_manifest()
            if self.mark_success:
                open(os.path.join(self.out_path, SUCCESS_NAME), "w").close()

    def __enter__(self) -> "OutputWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close(success_marker=exc[0] is None)
