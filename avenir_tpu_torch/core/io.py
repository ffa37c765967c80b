"""Text I/O: the port's copy of the parts of ``avenir_tpu/core/io.py`` the
Naive Bayes jobs use.

Delimited records come in from a file or from every part file of a job
output directory (non-hidden files, sorted); job output goes out as
``<out>/part-r-00000`` plus a ``_SUCCESS`` marker.  The part file is
written to a temporary file in the same directory and published with
``fsync`` and ``os.replace``, so a crash never leaves a torn file under
the final name.  Every output directory also gets the reference's
``_MANIFEST`` sidecar (per-part byte length and sha1).  The ingest cache
validates its artifacts against it (``validate_artifact_dir``);
``read_lines`` does not validate job inputs yet, and the in-memory
artifact store is not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from typing import Dict, Iterable, Iterator, List, Optional

SUCCESS_NAME = "_SUCCESS"
MANIFEST_NAME = "_MANIFEST"
MANIFEST_VERSION = 1


class TornArtifactError(RuntimeError):
    """An artifact directory failed validation: a part whose size or sha1
    disagrees with the ``_MANIFEST``, a part the manifest does not list,
    or a listed part that is gone."""


def _input_files(path: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if not f.startswith(("_", ".")) and os.path.isfile(os.path.join(path, f))
        )
    return [path]


def read_lines(path: str) -> Iterator[str]:
    """Yield every non-empty record line from a file or job-output
    directory."""
    for fp in _input_files(path):
        with open(fp, "r") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line:
                    yield line


def read_buffer(path: str) -> bytes:
    """The bytes of a file, or of every part file of a directory joined by
    newlines (the chunked encoder splits this buffer into row chunks)."""
    parts = []
    for fp in _input_files(path):
        with open(fp, "rb") as fh:
            parts.append(fh.read())
    return b"\n".join(parts)


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


def write_output(out_path: str, lines: Iterable[str]) -> str:
    """Write job output as ``<out_path>/part-r-00000`` (atomically, with
    the ``_MANIFEST`` and ``_SUCCESS`` of ``OutputWriter``); returns the
    part file's path."""
    with OutputWriter(out_path) as w:
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
        raise TornArtifactError(f"{mpath} is unreadable ({e}): artifact "
                                f"torn; re-run the producing job") from None


def validate_artifact_dir(path: str, files: List[str]) -> None:
    """Check every part in ``files`` against the directory's
    ``_MANIFEST`` (byte length and sha1), and that every listed part
    still exists.  A directory without a manifest passes.  Raises
    :class:`TornArtifactError` naming the path and the part."""
    doc = load_manifest(path)
    if doc is None:
        return
    parts = doc["parts"]
    for fp in files:
        name = os.path.basename(fp)
        rec = parts.get(name)
        if not isinstance(rec, dict):
            raise TornArtifactError(f"{path}: part {name} is not in "
                                    f"{MANIFEST_NAME}")
        size = os.path.getsize(fp)
        if size != rec.get("bytes"):
            raise TornArtifactError(
                f"{path}: part {name} is {size} bytes but {MANIFEST_NAME} "
                f"records {rec.get('bytes')}")
        if _sha1_file(fp) != rec.get("sha1"):
            raise TornArtifactError(f"{path}: part {name} checksum mismatch "
                                    f"against {MANIFEST_NAME}")
    lost = sorted(set(parts) - {os.path.basename(fp) for fp in files})
    if lost:
        raise TornArtifactError(f"{path}: {MANIFEST_NAME} records part(s) "
                                f"{', '.join(lost)} that no longer exist")


def _atomic_write_text(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
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


class OutputWriter:
    """One part file of an artifact directory, written crash-safely: the
    part is staged to a temporary file in the same directory and published
    with ``fsync`` and ``os.replace``, then merged into the directory's
    ``_MANIFEST``, and (with ``mark_success``) the ``_SUCCESS`` marker is
    written.  ``binary=True`` takes bytes through :meth:`write_bytes`.
    Closing after an exception discards the stage."""

    def __init__(self, out_path: str, name: str = "part-r-00000",
                 binary: bool = False, mark_success: bool = True):
        self.out_path = out_path
        self.mark_success = mark_success
        os.makedirs(out_path, exist_ok=True)
        self.file_path = os.path.join(out_path, name)
        fd, self._tmp_path = tempfile.mkstemp(prefix="." + name + ".",
                                              dir=out_path)
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
        _atomic_write_text(mpath, json.dumps(
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
        os.replace(self._tmp_path, self.file_path)
        self._update_manifest()
        if self.mark_success:
            open(os.path.join(self.out_path, SUCCESS_NAME), "w").close()

    def __enter__(self) -> "OutputWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close(success_marker=exc[0] is None)
