"""Replica scorer pool: N batcher+scorer replicas per model variant.

The port's copy of ``avenir_tpu/serve/pool.py``, with its device
placement written for PyTorch.  One scorer behind one dispatch worker
serializes a model's whole traffic; here each (model, variant) owns a
POOL of replicas — one complete adapter + micro-batcher + circuit
breaker per replica, each on an explicit ``torch.device`` (the server's
card, cycled round-robin over the visible cards when there is more than
one; the CPU when the server runs there) — and requests dispatch to the
LEAST-LOADED replica by queue depth (Clipper's adaptive-batching tier,
scaled horizontally).

Structure:

- :class:`Replica`       — one adapter + batcher + breaker.  Hot-swap
  reload and the circuit breaker are PER-REPLICA: one replica rebuilding
  (or tripped open) keeps serving traffic on its siblings.
- :class:`VariantGroup`  — a variant's replica set + the aggregated
  stats facade the rolling SLO monitor (serve/slo.py) observes, plus the
  variant-level soft-degrade bit the router reads.
- :class:`ScorerPool`    — every model's ordered variant groups; owns
  build/reload/close and the least-loaded submit path.

Config surface (serve.properties; README "Online serving"):

- ``serve.pool.replicas`` — replicas per (model, variant): an int, or
  ``auto`` for one per visible CUDA card (1 on the CPU; default 1);
  per-model override
  ``serve.model.<name>.pool.replicas``.

Dispatch semantics: ``submit`` tries replicas in ascending queue-depth
order; a replica whose breaker is open (or whose queue sheds) is skipped
and the next one tried, so a single replica failure degrades capacity,
not availability.  Only when EVERY replica refuses does the caller see
the error — sheds win over breaker errors so overload still reads as
overload.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..core import sanitizer, telemetry
from ..core.metrics import Counters
from ..device import resolve_device
from .batcher import (KEY_POISON_ISOLATE, MicroBatcher, PoisonQuarantine,
                      ShedError)
from .breaker import CircuitBreaker, CircuitOpenError
from .registry import DEFAULT_VARIANT, ModelEntry, ModelRegistry

KEY_REPLICAS = "serve.pool.replicas"
DEFAULT_REPLICAS = 1

SERVE_GROUP = "Serve"


def _resolve_replicas(config, model: str, device) -> int:
    """Replica count for one model: per-model override, then the global
    ``serve.pool.replicas`` (``auto`` = one per visible CUDA card when
    the server's ``device`` is a card, 1 on the CPU)."""
    raw = config.get(f"serve.model.{model}.pool.replicas")
    if raw is None:
        raw = config.get(KEY_REPLICAS, str(DEFAULT_REPLICAS))
    raw = str(raw).strip()
    if raw == "auto":
        if device.type != "cuda":
            return 1
        return max(1, torch.cuda.device_count())
    n = int(raw)
    if n < 1:
        raise ValueError(f"serve.pool.replicas must be >= 1 or auto: {raw}")
    return n


def _devices_for(n_replicas: int, device) -> List[torch.device]:
    """Round-robin device assignment, one explicit ``torch.device`` per
    replica: every replica on the CPU when the server runs there, else
    the visible cards cycled from the server's card.  Never ``None``: in
    PyTorch an unplaced tensor lives on the CPU, so a replica without a
    device would score there silently."""
    if device.type != "cuda":
        return [device] * n_replicas
    count = max(1, torch.cuda.device_count())
    return [torch.device("cuda", (device.index + i) % count)
            for i in range(n_replicas)]


def _pin(fn: Callable, device: torch.device) -> Callable:
    """Wrap a predict fn so its device work runs with the replica's card
    as the batcher thread's current CUDA device (no wrapper on the
    CPU)."""
    if device.type != "cuda":
        return fn

    def pinned(lines):
        with torch.cuda.device(device):
            return fn(lines)

    return pinned


class Replica:
    """One scorer replica: adapter + dispatch batcher + breaker."""

    __slots__ = ("model", "variant", "index", "device", "entry", "batcher")

    def __init__(self, model: str, variant: str, index: int, device,
                 entry: ModelEntry, batcher: MicroBatcher):
        self.model = model
        self.variant = variant
        self.index = index
        self.device = device
        self.entry = entry
        self.batcher = batcher

    def depth(self) -> int:
        return self.batcher.depth()

    def state(self) -> dict:
        b = self.batcher
        brk = b.breaker
        return {"replica": self.index,
                "version": self.entry.version,
                "queue_depth": b.depth(),
                "worker_alive": b.worker_alive(),
                "breaker": brk.state if brk is not None else "closed",
                "device": str(self.device)}


class _SummedHist:
    """Aggregated cumulative latency histogram across a variant's
    replicas — presents the ``_state()/bounds`` surface ModelSLO diffs.
    Rebuilt on reload, so the monitor's identity check resets the
    window exactly as it does for a single swapped batcher."""

    def __init__(self, hists):
        self.hists = list(hists)
        self.bounds = self.hists[0].bounds

    def _state(self):
        counts = None
        n, total = 0, 0.0
        for h in self.hists:
            c, hn, ht, _vmin, _vmax = h._state()
            if counts is None:
                counts = list(c)
            else:
                counts = [a + b for a, b in zip(counts, c)]
            n += hn
            total += ht
        return counts, n, total, None, None


def merged_hist_state(hists) -> dict:
    """One mergeable ``state_dict`` summing several LatencyHistograms
    that share one bound ladder (a variant group's replicas) — the form
    the telemetry overlay ships per (model, variant).  Each histogram is
    snapshotted ONCE (counts and exemplars from the same state), with
    exemplars merged latest-timestamp-wins via the shared telemetry
    rule."""
    from ..core.telemetry import merge_exemplar_states

    hists = list(hists)
    out = hists[0].state_dict()
    counts = {int(i): c for i, c in out.get("counts", {}).items()}
    vmin = out.get("vmin")
    vmax = out.get("vmax")
    ex = dict(out.get("exemplars") or {})
    for h in hists[1:]:
        s = h.state_dict()
        for i, c in s.get("counts", {}).items():
            counts[int(i)] = counts.get(int(i), 0) + c
        out["n"] += s["n"]
        out["total"] += s["total"]
        if s.get("vmin") is not None:
            vmin = s["vmin"] if vmin is None else min(vmin, s["vmin"])
        if s.get("vmax") is not None:
            vmax = s["vmax"] if vmax is None else max(vmax, s["vmax"])
        ex = merge_exemplar_states(ex, s.get("exemplars"))
    out["counts"] = {str(i): c for i, c in sorted(counts.items())}
    out["vmin"] = vmin
    out["vmax"] = vmax
    if ex:
        out["exemplars"] = {i: ex[i] for i in sorted(ex)}
    elif "exemplars" in out:
        del out["exemplars"]
    return out


class _SummedCounters:
    """Read-only sum of the replicas' counters (the monitor diffs
    cumulative Serve counters)."""

    def __init__(self, counters: List[Counters]):
        self._counters = list(counters)

    def get(self, group: str, name: str) -> int:
        return sum(c.get(group, name) for c in self._counters)


class _GroupStats:
    """The batcher-shaped facade a :class:`~avenir_tpu_torch.serve.slo.ModelSLO`
    observes for a whole variant group; its ``breaker`` is the group
    itself (the soft-degrade sink)."""

    def __init__(self, group: "VariantGroup"):
        self.e2e_hist = _SummedHist(
            [r.batcher.e2e_hist for r in group.replicas])
        self.counters = _SummedCounters(
            [r.batcher.counters for r in group.replicas])
        self.breaker = group


class VariantGroup:
    """One model variant's replica set + health/SLO state."""

    def __init__(self, model: str, variant: str, replicas: List[Replica],
                 slo_key: Optional[str] = None):
        self.model = model
        self.variant = variant
        self.replicas = replicas
        # the key this group's rolling SLO monitor lives under on the
        # SLOBoard: the bare model name for the implicit single default
        # variant (the pre-pool surface), "model@variant" otherwise
        self.slo_key = slo_key if slo_key is not None else model
        self.latency_class = replicas[0].entry.latency_class
        self.accuracy_class = replicas[0].entry.accuracy_class
        self._lock = sanitizer.make_lock("serve.pool.group")
        self._slo_degraded = False
        self._slo_reason: Optional[str] = None
        self.stats_facade = _GroupStats(self)

    # -- soft-degrade sink (SLOBoard calls this through the facade) --------
    def set_soft_degraded(self, flag: bool,
                          reason: Optional[str] = None) -> None:
        """The variant-level SLO-sustained-violation bit the router reads
        to demote this variant; forwarded to every replica breaker so
        per-replica state reporting agrees."""
        with self._lock:
            self._slo_degraded = bool(flag)
            self._slo_reason = reason if flag else None
        for r in self.replicas:
            if r.batcher.breaker is not None:
                r.batcher.breaker.set_soft_degraded(flag, reason)

    @property
    def soft_degraded(self) -> bool:
        with self._lock:
            return self._slo_degraded

    @property
    def soft_degrade_reason(self) -> Optional[str]:
        with self._lock:
            return self._slo_reason

    # -- health ------------------------------------------------------------
    def admitting_replicas(self) -> int:
        """Replicas currently able to take a request: worker alive and
        breaker not open (half-open counts: probes are admitted)."""
        n = 0
        for r in self.replicas:
            brk = r.batcher.breaker
            if not r.batcher.worker_alive():
                continue
            if brk is not None and brk.state == "open":
                continue
            n += 1
        return n

    def available(self) -> bool:
        return self.admitting_replicas() > 0

    def healthy(self) -> bool:
        """Routable without demotion: some replica admits AND the rolling
        SLO window is not in sustained violation."""
        return self.available() and not self.soft_degraded

    def depth(self) -> int:
        return sum(r.depth() for r in self.replicas)

    # -- dispatch ----------------------------------------------------------
    def _replica_at(self, index: int) -> Optional[Replica]:
        for r in self.replicas:          # re-read: reload swaps the list
            if r.index == index:
                return r
        return None

    def _try_replicas(self, attempt: Callable[[Replica], object]):
        """The ONE dispatch policy, shared by both wire paths: replicas
        in ascending queue-depth order; breaker-open/shedding replicas
        are skipped; a batcher closed by a concurrent hot-swap reload is
        retried once on its swapped REPLACEMENT (the list entry at the
        same index).  Raises only when every replica refuses (sheds
        outrank breaker errors)."""
        order = sorted(self.replicas, key=lambda r: r.batcher.depth())
        shed_exc = None
        open_exc = None
        for rep in order:
            try:
                return attempt(rep)
            except CircuitOpenError as e:
                open_exc = e
            except ShedError as e:
                shed_exc = e
            except RuntimeError as e:
                fresh = self._replica_at(rep.index)
                if fresh is None or fresh is rep:
                    open_exc = open_exc or e
                    continue
                try:
                    return attempt(fresh)
                except ShedError as e2:
                    shed_exc = e2
                except (CircuitOpenError, RuntimeError) as e2:
                    open_exc = open_exc or e2
        if shed_exc is not None:
            raise shed_exc
        raise open_exc if open_exc is not None else ShedError(
            f"no replica of {self.model}@{self.variant} accepted")

    def submit(self, line: str, ctx=None):
        """Least-loaded dispatch of one request line; see
        :meth:`_try_replicas` for the skip/retry policy.  ``ctx`` is the
        wire request's trace context, carried into the queue entry."""
        return self._try_replicas(
            lambda rep: rep.batcher.submit(line, ctx=ctx))

    def submit_many(self, lines, ctx=None):
        """One wire request's client-side batch to ONE replica (the
        least-loaded), under one lock round (`MicroBatcher.submit_many`)
        — splitting a batch across replicas would only shrink every
        micro-batch.  Returns ``(futures, shed)`` with ``None`` slots
        for shed rows (per-row sheds never raise here)."""
        return self._try_replicas(
            lambda rep: rep.batcher.submit_many(lines, ctx=ctx))

    def section(self, slo_stats: Optional[dict] = None) -> dict:
        """The per-variant dict health/stats report."""
        d = {"latency_class": self.latency_class,
             "accuracy_class": self.accuracy_class,
             "replicas": [r.state() for r in self.replicas],
             "admitting": self.admitting_replicas(),
             "queue_depth": self.depth(),
             "soft_degraded": self.soft_degraded,
             "healthy": self.healthy()}
        if self.soft_degrade_reason:
            d["soft_degrade_reason"] = self.soft_degrade_reason
        if slo_stats is not None:
            d["slo"] = slo_stats
        return d


class ScorerPool:
    """Every served model's ordered variant groups; owns construction,
    per-replica hot swap, warmup, and shutdown."""

    def __init__(self, config, registry: ModelRegistry,
                 batch_kw: dict, warmup: bool = True):
        self.config = config
        self.registry = registry
        # the server's device: cuda:0 unless the registry was given
        # another (the CPU in tests); raises when no card is present
        self.device = resolve_device(registry.device)
        self.batch_kw = dict(batch_kw)
        self.warmup = warmup
        self._lock = sanitizer.make_lock("serve.pool")
        # model -> variant (declared cost order) -> group
        self.groups: Dict[str, Dict[str, VariantGroup]] = {}
        # poison-batch isolation (serve.poison.*; batcher.py): one
        # quarantine per MODEL, shared by every replica of every variant
        # so a poison client bouncing between replicas still accumulates
        self.poison_isolate = config.get_boolean(KEY_POISON_ISOLATE, False)
        self.quarantines: Dict[str, Optional[PoisonQuarantine]] = {}
        # model -> highest router-lease generation applied by scale():
        # the idempotence fence that keeps a deposed leader's in-flight
        # scale from fighting the new leader's (fleet/lease.py)
        self._scale_gen: Dict[str, int] = {}
        try:
            for name in registry.model_names():
                self._load_model(name)
        except BaseException:
            # a later model failing to build must not leak the worker
            # threads / device tables of the ones already loaded
            self.close()
            raise

    # -- construction ------------------------------------------------------
    def _make_batcher(self, entry: ModelEntry, replica: int,
                      predict_fn) -> MicroBatcher:
        multi = len(self.registry.variant_names(entry.name)) > 1
        tag = entry.variant if (multi or entry.variant != DEFAULT_VARIANT) \
            else None
        return MicroBatcher(
            entry.name, predict_fn, entry.counters,
            breaker=CircuitBreaker.from_config(self.config, entry.name),
            fault_tag=tag, poison_isolate=self.poison_isolate,
            # through the locked helper, not an unlocked map read: a
            # dynamic-registration caller racing a reload still hands
            # every replica the model's ONE shared quarantine
            quarantine=self._ensure_quarantine(entry.name),
            **self.batch_kw)

    def _build_replica(self, name: str, variant: str, index: int, device,
                       counters: Optional[Counters] = None) -> Replica:
        entry = self.registry.build(name, variant, counters=counters,
                                    device=device)
        telemetry.watch_device(device)
        if self.warmup:
            self.registry._warm(entry)
        batcher = self._make_batcher(
            entry, index, _pin(entry.adapter.predict_lines, device))
        return Replica(name, variant, index, device, entry, batcher)

    def _ensure_quarantine(self, name: str) -> Optional[PoisonQuarantine]:
        """The model's shared poison quarantine, created at most once.
        Today _load_model only runs from single-threaded construction,
        but the quarantine map is read from reload/command threads —
        mutate it under the pool lock so a future dynamic-registration
        caller cannot introduce the race silently."""
        if not self.poison_isolate:
            return None
        with self._lock:
            q = self.quarantines.get(name)
            if q is None:
                q = self.quarantines[name] = PoisonQuarantine.from_config(
                    self.config)
            return q

    def _load_model(self, name: str) -> None:
        variants = self.registry.variant_names(name)
        groups: Dict[str, VariantGroup] = {}
        try:
            for v in variants:
                groups[v] = self.build_variant_group(name, v)
        except BaseException:
            # e.g. a later variant with no declared overlay: stop the
            # batcher workers the earlier groups already started (a
            # failing group closes its own partial build)
            for g in groups.values():
                for rep in g.replicas:
                    rep.batcher.close()
            raise
        with self._lock:
            self.groups[name] = groups
        # the registry keeps serving its legacy surface (get/entries =
        # the PRIMARY replica of the preferred variant)
        self.registry.adopt(groups[variants[0]].replicas[0].entry)

    # -- managed-cache surface (serve/modelcache.py) -----------------------
    def build_variant_group(self, name: str, variant: str) -> VariantGroup:
        """Build one variant's complete replica set WITHOUT installing it
        — the model cache's promote worker builds off the request path
        (the pre-swap pattern: nothing observable changes until the
        group installs), closing the built batchers itself on failure."""
        self._ensure_quarantine(name)
        variants = self.registry.variant_names(name)
        if variant not in variants:
            raise KeyError(
                f"model {name!r} declares no variant {variant!r} "
                f"(declared: {', '.join(variants)})")
        n = _resolve_replicas(self.config, name, self.device)
        devices = _devices_for(n, self.device)
        single_default = variants == [DEFAULT_VARIANT]
        reps: List[Replica] = []
        try:
            for i in range(n):
                reps.append(self._build_replica(name, variant, i,
                                                devices[i]))
        except BaseException:
            for rep in reps:
                rep.batcher.close(drain=False)
            raise
        return VariantGroup(
            name, variant, reps,
            slo_key=name if single_default else f"{name}@{variant}")

    def install_group(self, name: str, group: VariantGroup) -> None:
        """Install a built variant group, preserving the model's DECLARED
        variant order (the router iterates groups in cost order), and
        re-adopt the preferred resident variant's primary entry into the
        registry surface."""
        order = self.registry.variant_names(name)
        with self._lock:
            groups = dict(self.groups.get(name) or {})
            old = groups.get(group.variant)
            groups[group.variant] = group
            self.groups[name] = {
                v: groups[v] for v in order if v in groups}
            head = next(g for g in self.groups[name].values())
        if old is not None:
            for rep in old.replicas:
                rep.batcher.close(drain=True)
        self.registry.adopt(head.replicas[0].entry)

    def unload_variant(self, name: str, variant: str) -> bool:
        """Drop ONE variant group (drain its batchers, release its
        replicas' device state).  The model keeps serving its remaining
        variants; dropping the last group unloads the model."""
        with self._lock:
            groups = self.groups.get(name)
            if not groups or variant not in groups:
                return False
            g = groups.pop(variant)
            last = not groups
            if last:
                del self.groups[name]
            head = next(iter(groups.values())) if groups else None
        for rep in g.replicas:
            rep.batcher.close(drain=True)
        if last:
            self._forget_model(name)
        elif head is not None:
            self.registry.adopt(head.replicas[0].entry)
        return True

    def unload_model(self, name: str) -> bool:
        """Drop EVERY variant group of a model (the cache DEMOTE path):
        batchers drain (queued requests complete), device tables are
        released with the replicas, the registry forgets the adopted
        entries, and the model's poison quarantine is cleared — a later
        re-promote builds a FRESH replica set, so stale offender
        signatures must not re-quarantine rows against it (the
        demote→re-promote fix regression-tested in
        tests/test_modelcache.py)."""
        with self._lock:
            groups = self.groups.pop(name, None)
        if not groups:
            return False
        for g in groups.values():
            for rep in g.replicas:
                rep.batcher.close(drain=True)
        self._forget_model(name)
        return True

    def _forget_model(self, name: str) -> None:
        """Shared demote bookkeeping: drop the registry's adopted entries
        and the model's poison-quarantine signatures (same rationale as
        the whole-model reload clear: the next resident set is a fresh
        build and deserves a fresh trial)."""
        self.registry.drop(name)
        with self._lock:
            q = self.quarantines.pop(name, None)
        if q is not None:
            q.clear()

    # -- lookup ------------------------------------------------------------
    def model_names(self) -> List[str]:
        with self._lock:
            return list(self.groups)

    def variant_groups(self, model: str) -> List[VariantGroup]:
        with self._lock:
            groups = self.groups.get(model)
        if not groups:
            raise KeyError(f"model {model!r} is not loaded")
        return list(groups.values())

    def group(self, model: str, variant: str) -> VariantGroup:
        with self._lock:
            groups = self.groups.get(model)
        if not groups:
            raise KeyError(f"model {model!r} is not loaded")
        g = groups.get(variant)
        if g is None:
            raise KeyError(
                f"model {model!r} has no variant {variant!r} "
                f"(declared: {', '.join(groups)})")
        return g

    def primary_batcher(self, model: str) -> MicroBatcher:
        """The preferred variant's replica-0 batcher (the legacy
        single-batcher surface tests and the bench drive directly)."""
        return self.variant_groups(model)[0].replicas[0].batcher

    def replicas(self):
        with self._lock:
            snapshot = [g for groups in self.groups.values()
                        for g in groups.values()]
        for g in snapshot:
            for r in g.replicas:
                yield r

    def merged_counters(self, model: str) -> dict:
        """Counters summed across every replica of every variant (the
        model-level stats view; equals the single batcher's counters in
        the default 1-variant x 1-replica shape)."""
        merged: Dict[str, Dict[str, int]] = {}
        for g in self.variant_groups(model):
            for r in g.replicas:
                for grp, names in r.entry.counters.as_dict().items():
                    dst = merged.setdefault(grp, {})
                    for k, v in names.items():
                        dst[k] = dst.get(k, 0) + v
        return merged

    # -- lifecycle ---------------------------------------------------------
    def ensure_workers(self) -> None:
        for r in self.replicas():
            r.batcher.ensure_worker()

    def reload(self, model: str, variant: Optional[str] = None,
               replica: Optional[int] = None) -> ModelEntry:
        """Per-replica hot swap: rebuild the named scope (one replica,
        one variant, or the whole model) from the artifact files.  Each
        replica swaps independently — a fresh adapter + batcher + BREAKER
        (a repaired artifact must not inherit an open circuit) while its
        siblings keep serving; counters carry over per replica.

        Durability contract: every fresh replica of EVERY group in the
        reload scope is FULLY built before anything swaps — a build
        failure (e.g. a
        :class:`~avenir_tpu_torch.core.io.TornArtifactError` from manifest
        validation of a half-published artifact, in any variant) closes
        the already-built fresh replicas and leaves the OLD version
        serving untouched across all variants (asserted by the
        torn-artifact reload tests).  A whole-model reload also clears
        the model's poison quarantine: the repaired artifact deserves a
        fresh trial for previously poison rows."""
        groups = {g.variant: g for g in self.variant_groups(model)}
        if variant is not None and variant not in groups:
            raise KeyError(
                f"model {model!r} has no variant {variant!r}")
        if replica is not None:
            replica = int(replica)
        primary = None
        swapped = 0
        # phase 1: build EVERY fresh replica across the whole scope —
        # nothing observable changes until all of them exist
        plans = []          # (group, new_reps, retired, any_built)
        built = []
        try:
            for v, g in groups.items():
                if variant is not None and v != variant:
                    continue
                new_reps, retired = [], []
                for rep in g.replicas:
                    if replica is not None and rep.index != replica:
                        new_reps.append(rep)
                        continue
                    fresh = self._build_replica(
                        model, v, rep.index, rep.device,
                        counters=rep.entry.counters)
                    built.append(fresh)
                    new_reps.append(fresh)
                    retired.append(rep)
                    swapped += 1
                plans.append((g, new_reps, retired))
        except BaseException:
            # torn/missing artifact (or any build failure) in ANY
            # variant: stop every fresh replica this call already
            # started — no group's replica list was touched, the old
            # version keeps serving everywhere
            for fresh in built:
                fresh.batcher.close(drain=False)
            raise
        # phase 2: swap FIRST, drain the old batchers after: new
        # traffic lands on the fresh replicas immediately (with the
        # default single replica, draining before the swap would fail
        # every request for the whole drain window)
        for g, new_reps, retired in plans:
            if retired:
                g.replicas = new_reps
                # new facade identity -> the variant's SLO window restarts
                g.stats_facade = _GroupStats(g)
                g.set_soft_degraded(False)
                for rep in retired:
                    rep.batcher.close(drain=True)
            if primary is None:
                primary = g.replicas[0].entry
        for fresh in built:
            # count only reloads that actually swapped in
            fresh.entry.counters.incr(SERVE_GROUP, "Reloads")
        if replica is not None and swapped == 0:
            raise KeyError(
                f"model {model!r} has no replica {replica!r} in the "
                f"reload scope (indices 0..{len(next(iter(groups.values())).replicas) - 1})")
        if variant is None and replica is None:
            q = self.quarantines.get(model)
            if q is not None:
                q.clear()
        variants = self.registry.variant_names(model)
        head = groups[variants[0]].replicas[0].entry
        self.registry.adopt(head)
        return primary if primary is not None else head

    def scale(self, model: str, replicas: int,
              variant: Optional[str] = None,
              generation: Optional[int] = None) -> dict:
        """Grow or shrink a model's replica sets IN PLACE (the fleet
        router's autoscale command).  Growth rides the pre-swap build
        discipline: every new replica is fully built before any group's
        replica list changes, so a build failure leaves the old shape
        serving untouched.  Shrink retires the TAIL replicas with a
        draining close (queued requests complete on the retiring
        batcher).  The new count is persisted as the model's
        ``serve.model.<name>.pool.replicas`` override so later reloads
        rebuild at the scaled size.

        ``generation`` (optional) is the issuing router leader's lease
        generation (fleet/lease.py): a command below the highest
        generation this pool has applied for the model is refused — a
        deposed leader's in-flight decision cannot override the new
        leader's.  Equal generations pass (the same leader re-deciding);
        ungenerated commands (operator CLI) never fence."""
        n = int(replicas)
        if n < 1:
            raise ValueError(f"replicas must be >= 1: {replicas}")
        if generation is not None:
            gen = int(generation)
            with self._lock:
                last = self._scale_gen.get(model)
                if last is not None and gen < last:
                    raise ValueError(
                        f"stale scale for model {model!r}: generation "
                        f"{gen} < {last} (a newer router leader has "
                        f"already scaled this model)")
                self._scale_gen[model] = gen
        groups = {g.variant: g for g in self.variant_groups(model)}
        if variant is not None and variant not in groups:
            raise KeyError(f"model {model!r} has no variant {variant!r}")
        scope = [g for v, g in groups.items()
                 if variant is None or v == variant]
        before = max(len(g.replicas) for g in scope)
        devices = _devices_for(n, self.device)
        plans = []          # (group, new_reps, retired)
        built: List[Replica] = []
        try:
            for g in scope:
                cur = list(g.replicas)
                if n > len(cur):
                    fresh = [self._build_replica(model, g.variant, i,
                                                 devices[i])
                             for i in range(len(cur), n)]
                    built.extend(fresh)
                    plans.append((g, cur + fresh, []))
                elif n < len(cur):
                    plans.append((g, cur[:n], cur[n:]))
        except BaseException:
            for rep in built:
                rep.batcher.close(drain=False)
            raise
        for g, new_reps, retired in plans:
            # swap first, drain after — same ordering as reload; growth
            # keeps the existing replicas' batchers (and their windows'
            # source hists) but the facade identity still changes so the
            # variant's SLO window restarts at the new aggregate shape
            g.replicas = new_reps
            g.stats_facade = _GroupStats(g)
            g.set_soft_degraded(False)
            for rep in retired:
                rep.batcher.close(drain=True)
        if variant is None and plans:
            self.config.set(f"serve.model.{model}.pool.replicas", str(n))
        return {"model": model, "replicas": n, "previous": before,
                "scaled_groups": len(plans)}

    def seed_quarantine(self, model: str, signatures: Dict[str, int]) -> dict:
        """Install sibling-quarantined poison signatures into the
        model's shared quarantine (the fleet router's ``quarantine``
        propagation verb).  Folds by max per signature (idempotent — a
        router re-pushing after restart is harmless); rows matching a
        seeded signature are refused AT SUBMIT, before this process's
        scorer ever sees them."""
        if model not in self.model_names():
            raise KeyError(f"unknown model {model!r}")
        q = self._ensure_quarantine(model)
        if q is None:
            raise ValueError(
                "poison quarantine disabled (serve.poison.isolate off "
                "or serve.poison.quarantine.threshold=0)")
        seeded = 0
        for sig, n in signatures.items():
            if q.seed(str(sig), n):
                seeded += 1
        return {"seeded": seeded, "size": q.size()}

    def close(self, drain: bool = False) -> None:
        with self._lock:
            groups = [g for gs in self.groups.values()
                      for g in gs.values()]
            self.groups.clear()
        for g in groups:
            for r in g.replicas:
                r.batcher.close(drain=drain)
