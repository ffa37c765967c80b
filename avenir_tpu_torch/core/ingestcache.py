"""Parse-once binary ingest cache: the port's copy of the matrix-cache half
of ``avenir_tpu/core/ingestcache.py``.

The first streamed scan of an input publishes its encoded output (the
binned int32 matrix, the raw pre-bin integer matrix for the fused
bin+count kernel K2, the float64 value matrix, the class column, and a
vocabulary sidecar) as an artifact directory.  Later runs validate the
artifact, ``mmap`` the matrices, seed their encoder's vocabularies from
the sidecar (in first-seen order) and go straight to the device, with no
parse and no encode.  The artifact format is the reference's.

Invalidation is structural: the artifact records an input fingerprint
(per part file: name, byte size, mtime_ns) and an encoder fingerprint
(sha1 of the canonical schema, the delimiter and the format version).
Any mismatch, a missing ``_SUCCESS``, a torn part (a ``_MANIFEST`` sha1
mismatch) or another ``chunk_rows`` is a miss, and the cold scan
rebuilds.  A build is staged in a private sibling directory and published
with one atomic ``os.rename``, so readers see nothing or one complete
artifact.  A warm run replays exactly the recorded chunks, so its output
is byte-identical to the cold run's.

Config: ``ingest.cache.enable`` (default false), ``ingest.cache.dir``
(default ``<input>.ingestcache``), ``ingest.cache.fused`` (default true:
the warm NB fold bins inside the count kernel from the raw matrix).

Not ported yet: the shared-scan tee (``MultiScanCacheTee``) and the
Markov pair cache, which wait for their slices.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import List, Optional

import numpy as np

KEY_CACHE_ENABLE = "ingest.cache.enable"
KEY_CACHE_DIR = "ingest.cache.dir"
KEY_CACHE_FUSED = "ingest.cache.fused"

FORMAT_VERSION = 1
META_NAME = "meta.json"
_INT32_MAX = (1 << 31) - 1


def cache_base(cfg, in_path: str) -> str:
    """The cache root for ``in_path`` (one subdirectory per encoder)."""
    return (cfg.get(KEY_CACHE_DIR, None)
            or in_path.rstrip(os.sep) + ".ingestcache")


def cache_enabled(cfg) -> bool:
    return cfg is not None and cfg.get_boolean(KEY_CACHE_ENABLE, False)


def input_fingerprint(in_path: str) -> List[List]:
    """Per part file: [name, size, mtime_ns]."""
    from .io import _input_files

    out = []
    for fp in _input_files(in_path):
        st = os.stat(fp)
        out.append([os.path.basename(fp), st.st_size, st.st_mtime_ns])
    return out


def encoder_fingerprint(enc, delim: str) -> str:
    """sha1 over the canonical schema description, the delimiter and the
    format version."""
    desc = [{k: v for k, v in f.__dict__.items() if v is not None}
            for f in enc.schema.fields]
    blob = json.dumps({"v": FORMAT_VERSION, "delim": delim,
                       "fields": desc}, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def _load_validated_meta(d: str) -> Optional[dict]:
    """The artifact's meta, or None unless ``_SUCCESS`` is present and
    every part matches the ``_MANIFEST``."""
    from .io import SUCCESS_NAME, TornArtifactError, validate_artifact_dir

    if not os.path.isfile(os.path.join(d, SUCCESS_NAME)):
        return None
    try:
        files = sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if not f.startswith(("_", "."))
            and os.path.isfile(os.path.join(d, f)))
        validate_artifact_dir(d, files)
        with open(os.path.join(d, META_NAME), "r") as fh:
            meta = json.load(fh)
    except (TornArtifactError, OSError, ValueError):
        return None
    if meta.get("version") != FORMAT_VERSION:
        return None
    return meta


def _stage_path(final: str) -> str:
    """A private staging sibling for one build."""
    return f"{final}.stage-{os.getpid()}-{threading.get_ident()}"


def _publish_dir(stage: str, final: str, is_current) -> bool:
    """Move a staged artifact directory into place with one rename.  A
    loser of a publishing race keeps the winner's artifact when it
    answers the same key, and replaces stale or torn leftovers
    otherwise."""
    for _ in range(3):
        try:
            os.rename(stage, final)
            return True
        except OSError:
            if is_current(_load_validated_meta(final)):
                shutil.rmtree(stage, ignore_errors=True)
                return True
            shutil.rmtree(final, ignore_errors=True)
    shutil.rmtree(stage, ignore_errors=True)
    return False


class CachedScan:
    """A validated, mmapped artifact: ``x`` the binned int32 [n, F]
    matrix (raw unshifted bins, vocabulary codes, -1 for continuous
    columns), ``xraw`` the pre-bin integer matrix (None when a raw value
    fell outside int32), ``values`` float64 [n, F], ``y`` int32 [n]."""

    def __init__(self, d: str, meta: dict):
        n, F = int(meta["n_rows"]), int(meta["n_feat"])
        self.dir = d
        self.meta = meta
        self.n_rows = n
        self.chunk_rows = int(meta["chunk_rows"])
        self.chunk_row_counts = [int(c) for c in meta["chunk_row_counts"]]
        self.x = np.memmap(os.path.join(d, "x.bin"), dtype=np.int32,
                           mode="r", shape=(n, F))
        self.values = np.memmap(os.path.join(d, "values.bin"),
                                dtype=np.float64, mode="r", shape=(n, F))
        self.y = np.memmap(os.path.join(d, "y.bin"), dtype=np.int32,
                           mode="r", shape=(n,))
        self.xraw = (np.memmap(os.path.join(d, "xraw.bin"), dtype=np.int32,
                               mode="r", shape=(n, F))
                     if meta.get("raw_ok") else None)
        self._bounds = np.cumsum([0] + self.chunk_row_counts)

    def seed_encoder(self, enc) -> None:
        """Replay the sidecar vocabularies into ``enc`` in first-seen
        order, so it ends as the cold scan's encoder did."""
        for ord_str, vals in self.meta["vocabs"].items():
            vocab = enc.vocabs[int(ord_str)]
            for v in vals:
                vocab.add(v)
        if self.meta.get("class_vocab") is not None:
            for v in self.meta["class_vocab"]:
                enc.class_vocab.add(v)

    def chunk_slice(self, idx: int):
        """``(x, values, y, n)`` views of recorded chunk ``idx``, or None
        out of range."""
        if idx < 0 or idx >= len(self.chunk_row_counts):
            return None
        lo, hi = int(self._bounds[idx]), int(self._bounds[idx + 1])
        return self.x[lo:hi], self.values[lo:hi], self.y[lo:hi], hi - lo

    def chunks(self, with_raw: bool = False):
        """Replay the recorded chunks in order: ``(x, values, y, n,
        chunk_idx)``, with a leading ``xraw`` slice when ``with_raw``."""
        for i in range(len(self.chunk_row_counts)):
            lo, hi = int(self._bounds[i]), int(self._bounds[i + 1])
            row = (self.x[lo:hi], self.values[lo:hi], self.y[lo:hi],
                   hi - lo, i)
            yield ((self.xraw[lo:hi],) + row if with_raw else row)


class MatrixCacheBuilder:
    """Tees a cold streamed scan into the artifact, chunk by chunk (the
    parts append to staged files, so memory stays constant).  ``finish``
    publishes best-effort: a failed publish never fails the producing
    run, and torn leftovers miss on the next read and rebuild."""

    def __init__(self, cache: "IngestCache", chunk_rows: int):
        self.cache = cache
        self.chunk_rows = int(chunk_rows)
        self._stage = _stage_path(cache.dir)
        self._writers: Optional[dict] = None
        self._counts: List[int] = []
        self._raw_ok = True
        self._aborted = False
        # taken before the scan reads anything: a file changed mid-scan
        # mismatches the stat taken at the next load
        self._input_fp = input_fingerprint(cache.in_path)

    def _open(self) -> dict:
        from .io import OutputWriter

        os.makedirs(self._stage, exist_ok=True)
        return {name: OutputWriter(self._stage, name=name + ".bin",
                                   binary=True, mark_success=False)
                for name in ("x", "xraw", "values", "y")}

    def _raw_matrix(self, x, values, n: int):
        enc = self.cache.enc
        xraw = np.empty((n, x.shape[1]), dtype=np.int32)
        for j, f in enumerate(enc.feature_fields):
            if f.is_categorical():
                xraw[:, j] = x[:n, j]
            elif f.is_bucket_width_defined():
                v = values[:n, j]
                iv = v.astype(np.int64)
                if not ((iv == v).all()
                        and (np.abs(iv) <= _INT32_MAX).all()):
                    self._raw_ok = False
                    xraw[:, j] = 0
                else:
                    xraw[:, j] = iv.astype(np.int32)
            else:
                xraw[:, j] = -1      # continuous: the count drops it
        return xraw

    def add(self, x, values, y, n: int) -> None:
        if self._aborted:
            return
        try:
            if self._writers is None:
                self._writers = self._open()
            w = self._writers
            w["x"].write_bytes(np.ascontiguousarray(
                x[:n], dtype=np.int32).tobytes())
            w["xraw"].write_bytes(self._raw_matrix(x, values, n).tobytes())
            w["values"].write_bytes(np.ascontiguousarray(
                values[:n], dtype=np.float64).tobytes())
            w["y"].write_bytes(np.ascontiguousarray(
                y[:n], dtype=np.int32).tobytes())
            self._counts.append(int(n))
        except Exception:  # noqa: BLE001 — the cache build is best-effort
            self.abort()

    def abort(self) -> None:
        self._aborted = True
        if self._writers is not None:
            for w in self._writers.values():
                w.close(success_marker=False)
            self._writers = None
        shutil.rmtree(self._stage, ignore_errors=True)

    def _is_current(self, meta: Optional[dict]) -> bool:
        """Does ``meta`` describe a valid artifact for this build's key?"""
        return (meta is not None and meta.get("kind") == "encoded"
                and meta.get("encoder") == self.cache.enc_fp
                and meta.get("delim") == self.cache.delim
                and meta.get("input") == self._input_fp
                and meta.get("chunk_rows") == self.chunk_rows)

    def finish(self) -> bool:
        """Close the parts, write meta and ``_SUCCESS`` in the stage, then
        rename the stage into place.  True when a complete artifact for
        this build's key is in place."""
        from .io import OutputWriter

        if self._aborted or self._writers is None or not sum(self._counts):
            self.abort()
            return False
        enc = self.cache.enc
        meta = {
            "version": FORMAT_VERSION,
            "kind": "encoded",
            "input": self._input_fp,
            "encoder": self.cache.enc_fp,
            "delim": self.cache.delim,
            "n_rows": int(sum(self._counts)),
            "n_feat": len(enc.feature_fields),
            "chunk_rows": self.chunk_rows,
            "chunk_row_counts": self._counts,
            "raw_ok": bool(self._raw_ok),
            "vocabs": {str(f.ordinal): list(enc.vocabs[f.ordinal].values)
                       for f in enc.feature_fields if f.is_categorical()},
            "class_vocab": (list(enc.class_vocab.values)
                            if enc.class_field is not None else None),
        }
        try:
            for w in self._writers.values():
                w.close()
            self._writers = None
            with OutputWriter(self._stage, name=META_NAME,
                              mark_success=True) as mw:
                mw.write(json.dumps(meta, indent=1))
            return _publish_dir(self._stage, self.cache.dir,
                                self._is_current)
        except Exception:  # noqa: BLE001 — a torn publish misses next run
            self.abort()
            return False


class IngestCache:
    """The encoded-matrix cache of one (input, encoder, delimiter)."""

    def __init__(self, base: str, in_path: str, enc, delim: str):
        self.base = base
        self.in_path = in_path
        self.enc = enc
        self.delim = delim
        self.enc_fp = encoder_fingerprint(enc, delim)
        self.dir = os.path.join(base, "enc-" + self.enc_fp[:16])

    @classmethod
    def from_config(cls, cfg, in_path: str, enc,
                    delim: str) -> Optional["IngestCache"]:
        if not cache_enabled(cfg):
            return None
        return cls(cache_base(cfg, in_path), in_path, enc, delim)

    def load(self, chunk_rows: Optional[int]) -> Optional[CachedScan]:
        """A :class:`CachedScan` on a full hit, else None."""
        meta = _load_validated_meta(self.dir)
        if meta is None or meta.get("kind") != "encoded":
            return None
        if (meta.get("encoder") != self.enc_fp
                or meta.get("delim") != self.delim):
            return None
        try:
            if meta.get("input") != input_fingerprint(self.in_path):
                return None
        except OSError:
            return None
        if chunk_rows is not None and meta.get("chunk_rows") != chunk_rows:
            return None
        try:
            return CachedScan(self.dir, meta)
        except (OSError, ValueError):
            return None

    def builder(self, chunk_rows: int) -> MatrixCacheBuilder:
        return MatrixCacheBuilder(self, chunk_rows)
