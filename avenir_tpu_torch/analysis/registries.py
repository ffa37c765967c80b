"""Exclusion registries: deliberate rule opt-outs with written reasons.

The port's copy of ``avenir_tpu/analysis/registries.py``: the
:class:`ExclusionRegistry` class as it is, and registries that name the
port's own sites, each entry with a reason about the port's code.
Generalizes the ``NON_RETRYABLE`` / ``NON_ATOMIC_WRITES`` /
``NON_FUSABLE`` / ``NON_DAG_STAGES`` convention: an exclusion is a dict
entry ``site-key -> reason``, and the engine turns registry hygiene into
findings —

- an entry with an empty reason is an ``empty-reason`` finding;
- an entry whose key no longer names a live candidate violation is a
  ``stale-exclusion`` finding (the site was removed or fixed: drop the
  entry so the registry never rots into a list of historical lies).

The concurrency, hot-path and fold-algebra registries live here; the
four others stay in their owning core modules
(``core/resilience.py``, ``core/io.py``, ``core/multiscan.py``,
``core/dag.py``, as in the reference) and are wrapped by the same class
at rule-run time.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from .engine import Finding


class ExclusionRegistry:
    """One rule's exclusion dict plus the hygiene checks.

    ``entries`` maps a site key (rule-defined grammar, typically
    ``module.py:Qual.name``) to a non-empty written reason."""

    def __init__(self, rule_id: str, name: str, entries: Dict[str, str]):
        self.rule_id = rule_id
        self.name = name
        self.entries = entries

    def excuses(self, key: str) -> bool:
        return key in self.entries

    def hygiene_findings(self, candidates: Iterable[str],
                         file_of=None) -> List[Finding]:
        """Findings for empty reasons and stale entries.  ``candidates``
        is every site key that WOULD violate the rule absent exclusions;
        an entry not among them is stale.  ``file_of`` optionally maps a
        key to a file for the finding location (defaults to the key's
        ``module:`` prefix when it has one)."""
        cand = set(candidates)
        out: List[Finding] = []
        for key, reason in sorted(self.entries.items()):
            where = (file_of(key) if file_of
                     else (key.split(":", 1)[0] if ":" in key else ""))
            if not (reason and str(reason).strip()):
                out.append(Finding(
                    self.rule_id, where or self.name, 0,
                    f"{self.name} entry {key!r} has no written reason",
                    hint="every exclusion documents WHY it is safe",
                    tag="empty-reason"))
                continue
            if key not in cand:
                out.append(Finding(
                    self.rule_id, where or self.name, 0,
                    f"stale {self.name} entry {key!r}: no such violating "
                    f"site exists anymore",
                    hint="the site was removed or fixed — drop the entry",
                    tag="stale-exclusion"))
        return out


# ---------------------------------------------------------------------------
# the concurrency / hot-path registries
# ---------------------------------------------------------------------------

#: lock-discipline opt-outs: ``module.py:Class.attr`` (or
#: ``module.py:<module>.global``) -> why the unlocked mutation is safe.
SHARED_UNLOCKED: Dict[str, str] = {
    "serve/frontend.py:_Shard._posted":
        "single-consumer work queue of the port's frontend (a copy of the "
        "reference's): producers only append, the shard loop thread only "
        "popleft()s, and deque append/popleft are atomic under the GIL; "
        "the wake pipe orders the handoff",
    "serve/frontend.py:_Shard._conns":
        "touched only on the shard's own loop thread: adopt() runs on "
        "shard 0's acceptor loop (that same thread) or is marshaled via "
        "post(), and _close runs inside run()",
    "ops/histogram.py:<module>._wm_tables":
        "a memo of K2's (w, m) constant tables on the card, keyed by "
        "(widths, device): two threads that miss at once each build an "
        "identical int32 tensor from k2_constants and one store wins; "
        "each caller launches with the tensor it holds, so no launch "
        "reads a table another thread is writing. The module lock guards "
        "only the launch counters",
}

#: torch hot-path host-sync opt-outs: ``module.py:Qual:callname`` -> why
#: this deliberate host sync belongs on the hot path.
HOST_SYNC_ALLOWED: Dict[str, str] = {
    "core/pipeline.py:ChunkTransfer.__call__:synchronize":
        "the pinned staging buffer's reuse gate: a buffer may be "
        "overwritten only after the copy out of it has left, so the "
        "transfer waits on that copy's event; with two buffers a key it "
        "waits for the copy of two chunks back, which has long finished",
    "core/pipeline.py:ChunkTransfer.__call__:numpy":
        "buf.numpy() is a view of the pinned HOST staging buffer, filled "
        "in place before the non-blocking copy: no device value is read",
    "core/pipeline.py:ChunkFold.seed.place:np.asarray":
        "one-time carry seeding from a checkpoint's host arrays at scan "
        "start or resume (host -> device); not in the per-chunk loop",
    "core/pipeline.py:ChunkFold.host_copy:synchronize":
        "the checkpoint's carry copy: AsyncCheckpointSaver calls it one "
        "chunk after the snapshot was queued, so the wait overlaps the "
        "next fold instead of draining the pipeline",
    "core/pipeline.py:ChunkFold.host_copy:numpy":
        "reads the snapshot's pinned host buffers after their event, the "
        "checkpoint's own copy of the carry (see host_copy:synchronize)",
    "core/pipeline.py:ChunkFold.block:torch.cuda.synchronize":
        "the explicit barrier: streaming_fold calls block() only at "
        "prefetch depth 0, the serial no-overlap reference for timing",
    "core/pipeline.py:ChunkFold.result:cpu":
        "the end of the scan: the finished table comes to the host once, "
        "after the last chunk",
    "core/pipeline.py:ChunkFold.result:numpy":
        "the same end-of-scan read as ChunkFold.result:cpu",
    "serve/engine.py:NaiveBayesAdapter._score:cpu":
        "the server answers in text, so a batch's scores must reach the "
        "host once; on a card GraphedCall already returns host tensors "
        "(the call is then free), on the CPU it is a no-op",
    "serve/engine.py:NaiveBayesAdapter.predict_lines:numpy":
        "formats the host tensors that _score returned into the response "
        "lines; no device value is read here",
}

#: thread-lifecycle opt-outs: ``module.py:Qual`` (the scope creating the
#: Thread) -> why the thread needs neither a daemon flag nor a join.
UNMANAGED_THREADS: Dict[str, str] = {}


# ---------------------------------------------------------------------------
# the distributed-readiness registries (fold-algebra rule family)
# ---------------------------------------------------------------------------

#: fold-purity opt-outs: ``module.py:Qual:token`` (token = the impure
#: call's dotted name, or ``global:<name>`` for a mutable-global read)
#: -> why the host-local nondeterminism cannot diverge fold OUTPUT
#: across hosts.  Everything here is observability bookkeeping or a
#: deterministic memo — none of it flows into a fold carry or an
#: emitted artifact byte.
FOLD_IMPURE_ALLOWED: Dict[str, str] = {
    "ops/_build.py:load:global:_libs":
        "the loaded CUDA libraries, one a source, keyed by name: a hit "
        "and a fresh load give the same kernels (the .so is named by the "
        "digest of its source and flags), so the memo cannot change a "
        "count",
    "ops/histogram.py:_library:global:_lib":
        "the histogram kernel's library handle with its ctypes "
        "signatures, set once; the kernel's counts are held exact "
        "against its plain PyTorch version on every card run",
    "core/telemetry.py:sample_device_memory:time.monotonic":
        "rate-limit clock of the device.hbm.bytes gauge: the sampled "
        "value feeds telemetry only, never a carry or an output line",
    "core/telemetry.py:sample_device_memory:global:_DEVICE_SAMPLE":
        "the same gauge's rate limiter and watched-device list; no "
        "data-path effect",
    "core/telemetry.py:get_metrics:global:_GLOBAL_METRICS":
        "the process-global metrics registry: every write through it is "
        "a counter/gauge/histogram sample, never fold data",
    "core/obs.py:get_tracer:global:_GLOBAL_TRACER":
        "the process-global tracer handle: spans recorded through it are "
        "observability, and fold outputs never read it",
    "native/__init__.py:get_lib:global:_lib":
        "the lazily built native CSV library: the native and numpy "
        "encodes give the same bytes (the port's ingest tests hold them "
        "equal), so whether a host has it cannot change output",
    "core/faultinject.py:get_injector:global:_INJECTOR":
        "the config-driven fault-injection plan (test tooling): the same "
        "for every host of one configuration, and empty in production",
    "core/flight.py:trigger:global:_GLOBAL_RECORDER":
        "the flight recorder's dump-on-anomaly hook: write-only as far "
        "as a fold is concerned",
    "core/io.py:validate_artifact_dir:global:_REQUIRE_SUCCESS":
        "the io.require.success flag, set once by the CLI before any "
        "engine runs; the same on every host of one job config",
    "core/io.py:validate_artifact_dir:global:_VALIDATED":
        "manifest-validation memo keyed by (dir, stat): a hit and a "
        "re-validation give the same verdict for the same bytes",
    "core/io.py:read_lines:global:_ARTIFACTS":
        "the in-memory ArtifactStore overlay of the DAG's stage handoff: "
        "its first read is checked byte-equal to the file's, so the "
        "overlay cannot change the bytes a stage consumes",
    "core/io.py:write_output:global:_ARTIFACTS":
        "the same overlay on the write side: a registered output is also "
        "kept in memory; the bytes written do not change",
    "core/resilience.py:with_retries:global:_POLICY":
        "the retry policy (backoff shape), set once at CLI start: a "
        "retry re-runs the same read and never alters its result",
    "core/sanitizer.py:make_lock:global:_STATE":
        "the lock sanitizer's on/off flag read when a lock is made; "
        "tracked and plain locks behave the same for data",
    "core/pipeline.py:drive_prefetched:time.perf_counter_ns":
        "the clock of the consumer's ingest.wait span, read only while "
        "the tracer is on: no chunk, carry or output line reads it",
}

#: merge-closure opt-outs: class names exporting ``state_dict`` whose
#: state is DELIBERATELY not a mergeable snapshot type.
MERGE_EXEMPT: Dict[str, str] = {
    "CircuitBreaker":
        "serve/breaker.py's state_dict is a per-replica health report "
        "(the server's health/stats commands), not a cross-process "
        "snapshot: merging two replicas' trip counts would make a "
        "breaker no replica is in",
}

#: carry-portability opt-outs: ``module.py:Qual:token`` -> why this
#: host-topology read inside carry-producing code cannot bake a
#: host-count-dependent value into a fold carry or checkpoint.
HOST_TOPOLOGY_ALLOWED: Dict[str, str] = {
    "parallel/mesh.py:make_mesh:torch.cuda.device_count":
        "with no devices given, the mesh spans every visible card: mesh "
        "construction IS the topology surface. A carry's dtype and shape "
        "come from the data's caps, never from the card count, and the "
        "one-device bytes on [cpu] * 8 and [cuda:0] * 4 "
        "(tests/test_torch_mesh_jobs.py, chip_smoke.py's mesh_jobs) and "
        "the split-invariance certificate (core.algebra) hold it so",
    "parallel/mesh.py:get_mesh:torch.cuda.device_count":
        "the card count quoted in the bad-AVENIR_MESH error message only; "
        "the mesh's shape itself is operator config",
}
