"""Named locks: the port's copy of ``make_lock`` from
``avenir_tpu/core/sanitizer.py``.

The reference hands out a tracked lock when its lock-order sanitizer is
on; the sanitizer is a test tool of the JAX suite and is not ported, so
here every named lock is a plain ``threading.Lock``.  The name stays at
each call site, so the sanitizer can be put back behind this one
function.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A mutex for one named role (``name`` is unused: see the module
    docstring)."""
    del name
    return threading.Lock()
