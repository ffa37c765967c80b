"""Checkpoint and resume for streaming folds: the port's copy of the
streaming half of ``avenir_tpu/core/checkpoint.py``.

Every ``checkpoint.interval.chunks`` folded chunks the trainer writes a
sidecar holding

- the byte offset of the checkpointed chunk's end (chunk boundaries are
  deterministic, ``pipeline.row_chunk_ends`` over the whole buffer, so a
  resumed run derives the same chunking and skips whole chunks up to the
  offset),
- the fold carry copied to the host as a numpy array (never a live
  tensor: :func:`assert_portable_carry`, so a sidecar written by a CUDA
  run resumes on the CPU and the other way round),
- the host stream state pickled on the producer when the checkpointed
  chunk was produced (encoder vocabularies, moment accumulators,
  quarantine counts), so a prefetch worker running ahead cannot leak a
  later chunk's state into it,
- an input fingerprint and the chunking parameters, checked at load, so a
  sidecar never resumes against another file or chunk geometry.

``--resume`` on the CLI (``checkpoint.resume=true``) loads the sidecar and
restarts mid-file; the resumed run writes the bytes an uninterrupted one
writes, and a successful run deletes its sidecar.

Each save rotates the previous sidecar to ``<path>.1`` (then ``.2``, ...),
keeping ``checkpoint.keep`` generations; ``load`` walks them newest to
oldest, and a corrupt one (:class:`CheckpointCorrupt`) falls back to the
next.  With every generation corrupt, ``checkpoint.fallback`` decides:
``cold`` (the default) runs from the start, ``fail`` raises.  Recovery
events count in ``core.io``'s ``Durability`` group.

Config surface:

- ``checkpoint.interval.chunks`` -- checkpoint every N folded chunks
  (absent or 0: off)
- ``checkpoint.path``            -- the sidecar (default ``<out>.ckpt``)
- ``checkpoint.resume``          -- resume from the sidecar if present
- ``checkpoint.keep``            -- generations kept (default 2)
- ``checkpoint.fallback``        -- ``cold`` | ``fail``

:class:`WorkflowCheckpointer` is the workflow DAG's (core.dag)
stage-completion sidecar.

:class:`OffsetCheckpointer` is the stream feedback consumer's (offset,
posterior) sidecar (stream.consumer).

The reference pickles its own encoder, so sidecars are not read across
the two packages.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, Dict, List, Optional

from . import faultinject

KEY_INTERVAL = "checkpoint.interval.chunks"
KEY_PATH = "checkpoint.path"
KEY_RESUME = "checkpoint.resume"
KEY_KEEP = "checkpoint.keep"
KEY_FALLBACK = "checkpoint.fallback"

DEFAULT_KEEP = 2
FALLBACK_COLD = "cold"
FALLBACK_FAIL = "fail"

CKPT_VERSION = 1
_FP_HASH_BYTES = 1 << 20       # the fingerprint hashes the first 1 MB


class CheckpointMismatch(RuntimeError):
    """The sidecar does not match this run (another input file, other
    chunking parameters): resuming would break byte parity, so the run
    fails and asks for a run without ``--resume``."""


class CheckpointCorrupt(RuntimeError):
    """A sidecar failed to unpickle (a truncated write, disk damage).
    ``load`` walks past it to older generations; it surfaces only under
    ``checkpoint.fallback=fail`` with every generation corrupt."""


class CarryNotPortable(ValueError):
    """A fold carry offered for checkpointing holds a leaf that is not
    host data (e.g. a live ``torch.Tensor``)."""


def _durability_counters():
    from .io import _durability_counters as _dc
    return _dc()


def _fallback_from_config(config) -> str:
    mode = (config.get(KEY_FALLBACK, FALLBACK_COLD)
            or FALLBACK_COLD).strip().lower()
    if mode not in (FALLBACK_COLD, FALLBACK_FAIL):
        raise ValueError(
            f"{KEY_FALLBACK}={mode!r}: use {FALLBACK_COLD} or "
            f"{FALLBACK_FAIL}")
    return mode


def generation_paths(path: str, keep: int) -> List[str]:
    """Sidecar paths newest to oldest: ``path``, ``path.1``, ..."""
    return [path] + [f"{path}.{i}" for i in range(1, max(1, int(keep)))]


def _rotate_generations(path: str, keep: int) -> None:
    """Shift the existing generations one slot older before a new save
    lands at ``path`` (``keep=1`` keeps none)."""
    gens = generation_paths(path, keep)
    for i in range(len(gens) - 1, 0, -1):
        if os.path.exists(gens[i - 1]):
            os.replace(gens[i - 1], gens[i])


def _load_payload(path: str) -> Dict[str, Any]:
    """Unpickle one sidecar; every kind of corruption (a truncated file,
    garbled bytes, the wrong object) surfaces as
    :class:`CheckpointCorrupt`."""
    try:
        with open(path, "rb") as fh:
            payload = pickle.load(fh)
    except (OSError, pickle.PickleError, EOFError, AttributeError,
            ImportError, IndexError, MemoryError, UnicodeDecodeError,
            ValueError) as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is unreadable "
            f"({type(e).__name__}: {e})") from None
    if not isinstance(payload, dict):
        raise CheckpointCorrupt(
            f"checkpoint {path} does not hold a payload dict "
            f"({type(payload).__name__})")
    return payload


def _maybe_corrupt_sidecar(path: str, save_index: int) -> None:
    """The ``ckpt_corrupt`` fault point: truncate the just-written sidecar
    in place to half its size (a crash mid-write, disk damage), by save
    index, so the generation fallback of :meth:`StreamCheckpointer.load`
    can be driven deterministically."""
    fi = faultinject.get_injector()
    if fi is None or fi.armed("ckpt_corrupt", index=save_index) is None:
        return
    size = os.path.getsize(path)
    with open(path, "rb+") as fh:
        fh.truncate(max(size // 2, 1))


def input_fingerprint(path: str) -> Dict[str, Any]:
    """A cheap identity of the input file or directory: per part (name,
    size), plus a hash of the first part's head."""
    from .io import _input_files

    files = _input_files(path)
    parts = [(os.path.basename(fp), os.path.getsize(fp)) for fp in files]
    h = hashlib.sha1()
    if files:
        with open(files[0], "rb") as fh:
            h.update(fh.read(_FP_HASH_BYTES))
    return {"parts": parts, "head_sha1": h.hexdigest()}


def assert_portable_carry(carry: Any, context: str = "carry") -> Any:
    """Check that every leaf of a carry (nested dicts, lists, tuples) is
    host data: numpy arrays, numpy or Python scalars, None.  A tensor,
    on the card or not, is refused, so a sidecar never depends on the
    device it was written from."""
    import numpy as _np

    def walk(obj, path):
        if obj is None or isinstance(obj, (bool, int, float, str, bytes,
                                           _np.generic, _np.ndarray)):
            return
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}[{k!r}]")
            return
        if isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
            return
        raise CarryNotPortable(
            f"{context}: non-host leaf {type(obj).__module__}."
            f"{type(obj).__name__} at {path}; copy it to a numpy array "
            f"before checkpointing")

    walk(carry, context)
    return carry


class CheckpointToken:
    """One checkpoint-due marker, made on the producer: the chunk index
    and end offset plus the host stream state pickled at capture time (so
    later changes on the producer cannot leak in).  The consumer adds
    the fold carry and hands both to ``save``."""

    __slots__ = ("chunk_index", "offset", "state_bytes")

    def __init__(self, chunk_index: int, offset: int, state_obj: Any):
        self.chunk_index = int(chunk_index)
        self.offset = int(offset)
        self.state_bytes = pickle.dumps(state_obj,
                                        protocol=pickle.HIGHEST_PROTOCOL)


class StreamCheckpointer:
    """Sidecar writer and loader of one streaming scan."""

    def __init__(self, path: str, interval: int, kind: str, in_path: str,
                 params: Optional[Dict[str, Any]] = None,
                 resume: bool = False, keep: int = DEFAULT_KEEP,
                 fallback: str = FALLBACK_COLD):
        if interval < 1:
            raise ValueError(f"{KEY_INTERVAL} must be >= 1: {interval}")
        self.path = path
        self.interval = int(interval)
        self.kind = kind
        self.in_path = in_path
        self.params = dict(params or {})
        self.resume = bool(resume)
        self.keep = max(1, int(keep))
        self.fallback = fallback
        self.saves = 0
        self._fp = None

    def _fingerprint(self) -> Dict[str, Any]:
        """The input fingerprint, computed once per checkpointer (the
        whole buffer was read up front, so the input cannot change
        mid-scan)."""
        if self._fp is None:
            self._fp = input_fingerprint(self.in_path)
        return self._fp

    @classmethod
    def from_config(cls, config, kind: str, in_path: str, default_path: str,
                    params: Optional[Dict[str, Any]] = None
                    ) -> Optional["StreamCheckpointer"]:
        """None when checkpointing is off and no resume was asked for
        (``--resume`` alone implies an interval of 8, so an interrupted
        run resumes without repeating the interval key)."""
        interval = config.get_int(KEY_INTERVAL, 0)
        resume = config.get_boolean(KEY_RESUME, False)
        if interval <= 0 and not resume:
            return None
        return cls(config.get(KEY_PATH, default_path),
                   max(interval, 1) if interval > 0 else 8,
                   kind, in_path, params=params, resume=resume,
                   keep=config.get_int(KEY_KEEP, DEFAULT_KEEP),
                   fallback=_fallback_from_config(config))

    # -- producer side -----------------------------------------------------
    def due(self, chunk_index: int) -> bool:
        return (chunk_index + 1) % self.interval == 0

    def token(self, chunk_index: int, offset: int,
              state_obj: Any) -> CheckpointToken:
        return CheckpointToken(chunk_index, offset, state_obj)

    # -- consumer side -----------------------------------------------------
    def save(self, token: CheckpointToken, carry: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Write the sidecar atomically (a temporary file, then a rename:
        a crash mid-save leaves the previous checkpoint intact), after
        rotating the previous one a generation older."""
        payload = {
            "version": CKPT_VERSION,
            "kind": self.kind,
            "fingerprint": self._fingerprint(),
            "params": self.params,
            "chunk_index": token.chunk_index,
            "offset": token.offset,
            "state": token.state_bytes,
            "carry": assert_portable_carry(
                carry, context=f"{self.kind} checkpoint carry"),
            "extra": dict(extra or {}),
        }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=d)
        try:
            with os.fdopen(fd, "wb") as fh:
                pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
            _rotate_generations(self.path, self.keep)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _maybe_corrupt_sidecar(self.path, self.saves)
        self.saves += 1

    # -- resume side -------------------------------------------------------
    def _validate(self, path: str,
                  payload: Dict[str, Any]) -> Dict[str, Any]:
        if payload.get("version") != CKPT_VERSION:
            raise CheckpointMismatch(
                f"checkpoint {path}: version "
                f"{payload.get('version')} != {CKPT_VERSION}")
        if payload.get("kind") != self.kind:
            raise CheckpointMismatch(
                f"checkpoint {path}: kind {payload.get('kind')!r} "
                f"does not match this job ({self.kind!r})")
        if payload.get("fingerprint") != input_fingerprint(self.in_path):
            raise CheckpointMismatch(
                f"checkpoint {path} was written against a different "
                f"input than {self.in_path!r} — re-run without --resume")
        if payload.get("params") != self.params:
            raise CheckpointMismatch(
                f"checkpoint {path}: chunking/config params changed "
                f"({payload.get('params')} != {self.params}) — resuming "
                f"would break byte parity; re-run without --resume")
        try:
            payload["state"] = pickle.loads(payload["state"])
        except (KeyError, TypeError, pickle.PickleError, EOFError,
                AttributeError, ImportError, IndexError,
                UnicodeDecodeError, ValueError) as e:
            raise CheckpointCorrupt(
                f"checkpoint {path}: host stream state unreadable "
                f"({type(e).__name__}: {e})") from None
        return payload

    def load(self) -> Optional[Dict[str, Any]]:
        """The newest valid generation's payload with ``state``
        unpickled, or None when there is no sidecar (the run then starts
        from the beginning).  A corrupt generation falls back to the next
        older one; with every generation corrupt, ``checkpoint.fallback``
        applies.  A version, kind, fingerprint or params mismatch raises
        :class:`CheckpointMismatch`: an older generation of the same
        wrong run cannot repair it."""
        counters = _durability_counters()
        corrupt: List[str] = []
        for path in generation_paths(self.path, self.keep):
            if not os.path.exists(path):
                continue
            try:
                payload = self._validate(path, _load_payload(path))
            except CheckpointCorrupt as e:
                counters.incr("Durability", "Checkpoint corrupt")
                corrupt.append(str(e))
                continue
            if corrupt:
                counters.incr("Durability", "Generation fallbacks")
            return payload
        if not corrupt:
            return None
        if self.fallback == FALLBACK_FAIL:
            raise CheckpointCorrupt(
                f"every checkpoint generation of {self.path} is corrupt "
                f"({'; '.join(corrupt)}) and {KEY_FALLBACK}="
                f"{FALLBACK_FAIL}")
        counters.incr("Durability", "Cold starts")
        return None

    def complete(self) -> None:
        """Remove every generation after a successful run."""
        for path in generation_paths(self.path, self.keep):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# stream-offset checkpointing (the exactly-once feedback sidecar)
# ---------------------------------------------------------------------------

OFFSET_CKPT_VERSION = 1


class OffsetCheckpointer:
    """Offset + fold-carry sidecar for an unbounded stream consumer
    (the ``stream.consumer`` feedback consumer's exactly-once hinge).

    A file-scan checkpoint fingerprints its input file; a stream has no
    file, so identity is the DECLARED stream identity (stream key,
    consumer group, tenant/arm manifest, posterior dtype) — a sidecar
    written against a different stream or manifest raises
    :class:`CheckpointMismatch` instead of silently resuming the wrong
    posterior.  Everything else — atomic tmp+rename saves, generation
    rotation (``checkpoint.keep``), newest→oldest corruption fallback
    surfacing :class:`CheckpointCorrupt`, the ``checkpoint.fallback``
    policy, and the ``ckpt_corrupt`` fault point — is the same machinery
    :class:`StreamCheckpointer` uses, so the chaos soak exercises one
    durability layer, not two.

    The exactly-once contract: the LAST-APPLIED stream entry id and the
    fold carry persist in ONE payload, so a kill anywhere leaves a
    consistent (offset, carry) pair — resume re-reads the stream's
    pending entries and the offset watermark dedupes anything at or
    below it (duplicate delivery), while anything above it was never
    folded into this carry and applies exactly once.  Falling back a
    generation just lowers the watermark: the extra entries replay, and
    the integer-exact fold makes the result byte-identical.
    """

    def __init__(self, path: str, interval_events: int,
                 identity: Dict[str, Any], resume: bool = False,
                 keep: int = DEFAULT_KEEP, fallback: str = FALLBACK_COLD):
        if interval_events < 1:
            raise ValueError(
                f"checkpoint interval must be >= 1 event: {interval_events}")
        self.path = path
        self.interval = int(interval_events)
        self.identity = dict(identity)
        self.resume = bool(resume)
        self.keep = max(1, int(keep))
        self.fallback = fallback
        self.saves = 0

    @classmethod
    def from_config(cls, config, interval_events: int,
                    identity: Dict[str, Any],
                    default_path: str) -> Optional["OffsetCheckpointer"]:
        """None when checkpointing is off AND no resume was requested
        (mirrors :meth:`StreamCheckpointer.from_config`)."""
        resume = config.get_boolean(KEY_RESUME, False)
        if interval_events <= 0 and not resume:
            return None
        return cls(config.get(KEY_PATH, default_path),
                   interval_events if interval_events > 0 else 256,
                   identity, resume=resume,
                   keep=config.get_int(KEY_KEEP, DEFAULT_KEEP),
                   fallback=_fallback_from_config(config))

    def save(self, offset: str, carry: Any, state: Dict[str, Any]) -> None:
        """Atomically write (offset, carry, consumer state) as one
        sidecar, rotating the previous generation older first."""
        payload = {
            "version": OFFSET_CKPT_VERSION,
            "identity": self.identity,
            "offset": str(offset),
            "carry": assert_portable_carry(
                carry, context="stream-offset checkpoint carry"),
            "state": pickle.dumps(dict(state),
                                  protocol=pickle.HIGHEST_PROTOCOL),
        }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=d)
        try:
            with os.fdopen(fd, "wb") as fh:
                pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
            _rotate_generations(self.path, self.keep)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _maybe_corrupt_sidecar(self.path, self.saves)
        self.saves += 1

    def _validate(self, path: str,
                  payload: Dict[str, Any]) -> Dict[str, Any]:
        if payload.get("version") != OFFSET_CKPT_VERSION:
            raise CheckpointMismatch(
                f"stream checkpoint {path}: version "
                f"{payload.get('version')} != {OFFSET_CKPT_VERSION}")
        if payload.get("identity") != self.identity:
            raise CheckpointMismatch(
                f"stream checkpoint {path} was written against a "
                f"different stream identity ({payload.get('identity')} "
                f"!= {self.identity}) — re-run without --resume")
        try:
            payload["state"] = pickle.loads(payload["state"])
        except (KeyError, TypeError, pickle.PickleError, EOFError,
                AttributeError, ImportError, IndexError,
                UnicodeDecodeError, ValueError) as e:
            raise CheckpointCorrupt(
                f"stream checkpoint {path}: consumer state unreadable "
                f"({type(e).__name__}: {e})") from None
        return payload

    def load(self) -> Optional[Dict[str, Any]]:
        """The newest valid generation's (offset, carry, state), walking
        past corrupt generations exactly like
        :meth:`StreamCheckpointer.load` (an older generation's lower
        watermark just replays more pending entries — byte-identical)."""
        counters = _durability_counters()
        corrupt: List[str] = []
        for path in generation_paths(self.path, self.keep):
            if not os.path.exists(path):
                continue
            try:
                payload = self._validate(path, _load_payload(path))
            except CheckpointCorrupt as e:
                counters.incr("Durability", "Checkpoint corrupt")
                corrupt.append(str(e))
                continue
            if corrupt:
                counters.incr("Durability", "Generation fallbacks")
            return payload
        if not corrupt:
            return None
        if self.fallback == FALLBACK_FAIL:
            raise CheckpointCorrupt(
                f"every stream checkpoint generation of {self.path} is "
                f"corrupt ({'; '.join(corrupt)}) and {KEY_FALLBACK}="
                f"{FALLBACK_FAIL}")
        counters.incr("Durability", "Cold starts")
        return None

    def complete(self) -> None:
        for path in generation_paths(self.path, self.keep):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# stage-granularity checkpointing (the core.dag workflow sidecar)
# ---------------------------------------------------------------------------

WF_CKPT_VERSION = 1


class WorkflowCheckpointer:
    """Stage-completion sidecar for a core.dag workflow run.

    After every completed stage the workflow records the stage's params
    key (a hash of its class, resolved config and paths), a fingerprint
    of every input artifact it consumed (the declared input and each
    ``@<stage>`` dependency) and of its output, then rewrites the sidecar
    atomically.  A ``--resume`` run skips a stage only when all three
    still validate; otherwise the stage re-runs, from its own mid-scan
    :class:`StreamCheckpointer` sidecar when one survived the kill.  A
    successful workflow deletes the sidecar.
    """

    def __init__(self, path: str, in_path: str, resume: bool = False,
                 keep: int = DEFAULT_KEEP, fallback: str = FALLBACK_COLD):
        self.path = path
        self.in_path = in_path
        self.resume = bool(resume)
        self.keep = max(1, int(keep))
        self.fallback = fallback
        #: set when a corrupt sidecar degraded this resume to a fresh run
        #: (core.dag logs it)
        self.degraded_reason: Optional[str] = None
        self._stages: Dict[str, Dict[str, Any]] = {}
        if resume:
            self._load_generations()

    @classmethod
    def from_config(cls, config, path: str, in_path: str,
                    resume: bool) -> "WorkflowCheckpointer":
        return cls(path, in_path, resume=resume,
                   keep=config.get_int(KEY_KEEP, DEFAULT_KEEP),
                   fallback=_fallback_from_config(config))

    def _load_generations(self) -> None:
        """Walk the generations newest to oldest; a corrupt one falls
        back to an older one.  With none valid the run degrades to a
        fresh workflow (every stage re-runs) under
        ``checkpoint.fallback=cold``, or raises under ``fail``."""
        counters = _durability_counters()
        corrupt: List[str] = []
        for path in generation_paths(self.path, self.keep):
            if not os.path.exists(path):
                continue
            try:
                payload = _load_payload(path)
                stages = payload.get("stages")
                if not isinstance(stages, dict):
                    raise CheckpointCorrupt(
                        f"workflow checkpoint {path} has no stages table")
            except CheckpointCorrupt as e:
                counters.incr("Durability", "Workflow sidecar corrupt")
                corrupt.append(str(e))
                continue
            if payload.get("version") != WF_CKPT_VERSION:
                raise CheckpointMismatch(
                    f"workflow checkpoint {path}: version "
                    f"{payload.get('version')} != {WF_CKPT_VERSION}")
            if payload.get("fingerprint") != input_fingerprint(
                    self.in_path):
                raise CheckpointMismatch(
                    f"workflow checkpoint {path} was written against a "
                    f"different input than {self.in_path!r} — re-run "
                    f"without --resume")
            if corrupt:
                counters.incr("Durability", "Generation fallbacks")
            self._stages = stages
            return
        if not corrupt:
            return                      # no sidecar: a fresh run
        if self.fallback == FALLBACK_FAIL:
            raise CheckpointCorrupt(
                f"every workflow checkpoint generation of {self.path} is "
                f"corrupt ({'; '.join(corrupt)}) and {KEY_FALLBACK}="
                f"{FALLBACK_FAIL}")
        counters.incr("Durability", "Cold starts")
        self.degraded_reason = (
            f"workflow checkpoint {self.path} corrupt in every "
            f"generation — degrading to a fresh run (all stages re-run)")

    @staticmethod
    def params_key(obj: Any) -> str:
        import json
        return hashlib.sha1(
            json.dumps(obj, sort_keys=True, default=str).encode()
        ).hexdigest()

    def _fingerprint_ok(self, path: str, recorded) -> bool:
        from .io import TornArtifactError
        try:
            return input_fingerprint(path) == recorded
        except OSError:
            return False
        except TornArtifactError:
            # a torn artifact never validates a skip: the stage re-runs
            # and publishes it again
            return False

    def stage_done(self, sid: str, params_key: str,
                   in_paths: Dict[str, str],
                   out_paths: Dict[str, str]) -> bool:
        """True when ``sid`` completed under the same params and every
        recorded input and output still matches its fingerprint on disk.
        A memory-only output recorded an empty fingerprint and validates;
        a memory-only input never does (it died with the killed run)."""
        rec = self._stages.get(sid)
        if rec is None or rec["params"] != params_key:
            return False
        for label, p in in_paths.items():
            want = rec["inputs"].get(label)
            if want is None or want == {}:
                return False
            if not self._fingerprint_ok(p, want):
                return False
        for label, p in out_paths.items():
            want = rec["outputs"].get(label)
            if want is None:
                return False
            if want != {} and not self._fingerprint_ok(p, want):
                return False
        return True

    def record(self, sid: str, params_key: str, in_paths: Dict[str, str],
               out_paths: Dict[str, str]) -> None:
        """Record ``sid`` complete and rewrite the sidecar atomically."""
        outputs = {label: (input_fingerprint(p) if os.path.exists(p) else {})
                   for label, p in out_paths.items()}
        self._stages[sid] = {
            "params": params_key,
            "inputs": {label: (input_fingerprint(p)
                               if os.path.exists(p) else {})
                       for label, p in in_paths.items()},
            "outputs": outputs,
        }
        payload = {"version": WF_CKPT_VERSION,
                   "fingerprint": input_fingerprint(self.in_path),
                   "stages": self._stages}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".wfckpt-", dir=d)
        try:
            with os.fdopen(fd, "wb") as fh:
                pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
            _rotate_generations(self.path, self.keep)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _maybe_corrupt_sidecar(self.path, len(self._stages) - 1)

    def complete(self) -> None:
        """Remove every generation after a successful workflow."""
        for path in generation_paths(self.path, self.keep):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
