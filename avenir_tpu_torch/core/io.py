"""Text I/O: the port's copy of the parts of ``avenir_tpu/core/io.py`` the
Naive Bayes jobs use.

Delimited records come in from a file or from every part file of a job
output directory (non-hidden files, sorted); job output goes out as
``<out>/part-r-00000`` plus a ``_SUCCESS`` marker.  The part file is
written to a temporary file in the same directory and published with
``fsync`` and ``os.replace``, so a crash never leaves a torn file under
the final name.  The reference's ``_MANIFEST`` sidecar, its validation on
read and the in-memory artifact store are not ported yet.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Iterable, Iterator, List

SUCCESS_NAME = "_SUCCESS"


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
    """Write job output as ``<out_path>/part-r-00000`` (atomically) and
    mark the directory ``_SUCCESS``; returns the part file's path."""
    os.makedirs(out_path, exist_ok=True)
    file_path = os.path.join(out_path, "part-r-00000")
    fd, tmp = tempfile.mkstemp(prefix=".part-r-00000.", dir=out_path)
    try:
        with os.fdopen(fd, "w") as fh:
            for line in lines:
                fh.write(line)
                fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        # a manifest left by an earlier writer describes the part this
        # write replaces; readers of the reference package would refuse it
        stale = os.path.join(out_path, "_MANIFEST")
        if os.path.exists(stale):
            os.unlink(stale)
        os.replace(tmp, file_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    open(os.path.join(out_path, SUCCESS_NAME), "w").close()
    return file_path
