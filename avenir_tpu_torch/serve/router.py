"""SLO-aware variant router: pick the cheapest scorer variant that meets
the request's latency objective.

INFaaS (USENIX ATC 2021, PAPERS.md) frames serving as *model-less*: a
client declares an objective, not an implementation, and the system picks
among registered variants of the same model — here the f32 fast path and
the f64 strict-parity path every NB/Markov scorer already ships as
(engine.VARIANT_PRESETS).  The router closes the loop: ``serve/breaker.py`` grew the soft-degrade bit "the variant
router will read exactly this bit", ``serve/slo.py`` grew the rolling
per-variant p99 windows, and this module reads both.

Decision per request, over the model's variant groups in DECLARED COST
ORDER (``serve.model.<name>.variants``, cheapest first):

1. An explicit ``"variant": "f64"`` pin short-circuits routing (the
   operator asked for that scorer; degraded or not, they get it).
2. Groups that are unroutable — no admitting replica (breaker open /
   worker dead on every replica) or SLO-soft-degraded — are DEMOTED: the
   router moves on to the next variant before any request fails.  Only
   when every group is down does the submit error propagate.
3. With an SLO hint (request ``"slo_ms"``, else
   ``serve.router.default.slo.ms``), the first candidate whose rolling
   windowed p99 (``SLOBoard.peek``; optimistic before first data) meets
   the hint wins.  If none meets it, best-effort picks the candidate
   with the lowest observed p99 — or, with ``serve.router.strict=true``,
   the request gets a structured SLO-unattainable error instead.
4. Without a hint, the cheapest routable candidate wins.

Config surface (serve.properties; README "Online serving"):

- ``serve.router.default.slo.ms`` — SLO hint applied to requests that
  carry none (0/absent = no default; hint-less requests just take the
  cheapest healthy variant).
- ``serve.router.strict``        — when true, a hint no variant's
  rolling p99 can meet fails the request (``slo_unattainable``) instead
  of serving best-effort (default false).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..core import sanitizer
from .pool import ScorerPool, VariantGroup

KEY_DEFAULT_SLO_MS = "serve.router.default.slo.ms"
KEY_STRICT = "serve.router.strict"

SERVE_GROUP = "Serve"


class SLOUnattainableError(ValueError):
    """Raised in strict mode when no routable variant's rolling p99
    meets the request's SLO hint."""


class VariantRouter:
    """Per-request variant selection over a :class:`ScorerPool`.

    With a managed model cache attached (serve/modelcache.py), the
    router also knows the DECLARED variant order of cataloged models —
    variants that exist but are not (yet) device-resident are treated
    exactly like soft-degraded ones: demoted to a resident sibling
    before any request fails, counted in the demotions surface, and
    nudged back toward residency with a background promote.  A request
    that PINS a declared-but-non-resident variant gets the structured
    cold-start response instead of a routing error."""

    def __init__(self, config, pool: ScorerPool, slo_board, cache=None):
        self.pool = pool
        self.slo = slo_board
        self.cache = cache
        self.default_slo_ms = config.get_float(KEY_DEFAULT_SLO_MS, 0.0)
        self.strict = config.get_boolean(KEY_STRICT, False)
        self._lock = sanitizer.make_lock("serve.router")
        # model -> counts (the stats/telemetry surface)
        self._routed: Dict[Tuple[str, str], int] = {}
        self._demotions: Dict[str, int] = {}
        self._slo_misses: Dict[str, int] = {}

    # -- observed latency --------------------------------------------------
    def observed_p99_ms(self, group: VariantGroup) -> Optional[float]:
        """The variant's last rolling-window p99 (None before the first
        evaluated window — the optimistic cold-start default)."""
        stats = self.slo.peek(group.slo_key)
        if not stats:
            return None
        p99 = stats.get("p99_ms")
        return float(p99) if p99 is not None else None

    # -- the decision ------------------------------------------------------
    def route(self, model: str, slo_ms: Optional[float] = None,
              variant: Optional[str] = None) -> Tuple[VariantGroup, dict]:
        """Pick the variant group for one request; returns (group,
        decision dict).  Raises KeyError for unknown model/variant and
        :class:`SLOUnattainableError` in strict mode."""
        groups = self.pool.variant_groups(model)
        declared = (self.cache.declared_variants(model)
                    if self.cache is not None else None)
        if variant is not None:
            for g in groups:
                if g.variant == variant:
                    return g, self._done(model, g, groups, pinned=True,
                                         slo_ms=None)
            if declared is not None and variant in declared:
                # declared but not resident: the pin gets the structured
                # cold-start signal (promote enqueued), not a routing
                # error — the variant exists, it just is not loaded yet
                raise self.cache.variant_cold(model, variant, ctx=None)
            raise KeyError(
                f"model {model!r} has no variant {variant!r} "
                f"(declared: {', '.join(declared or (g.variant for g in groups))})")

        hint = slo_ms if slo_ms is not None else (
            self.default_slo_ms if self.default_slo_ms > 0 else None)
        healthy = [g for g in groups if g.healthy()]
        # demotion ladder: healthy -> merely-admitting -> everything
        # (when every group refuses, submit's error says why)
        candidates = (healthy
                      or [g for g in groups if g.available()]
                      or groups)
        chosen = None
        slo_met = True
        if hint is not None:
            # one SLOBoard read per candidate, reused by the pick, the
            # best-effort fallback, and the strict-mode error message
            p99s = [(g, self.observed_p99_ms(g)) for g in candidates]
            for g, p99 in p99s:
                if p99 is None or p99 <= hint:
                    chosen = g
                    break
            if chosen is None:
                if self.strict:
                    with self._lock:
                        self._slo_misses[model] = \
                            self._slo_misses.get(model, 0) + 1
                    raise SLOUnattainableError(
                        f"slo_unattainable: no variant of {model!r} has a "
                        f"rolling p99 <= {hint}ms "
                        f"(observed: "
                        + ", ".join(f"{g.variant}={p99}" for g, p99 in p99s)
                        + "); retry without the hint or with "
                          "serve.router.strict=false")
                # best effort: the lowest observed p99 still beats
                # failing the request
                slo_met = False
                chosen = min(
                    p99s,
                    key=lambda gp: (gp[1] if gp[1] is not None
                                    else float("inf")))[0]
        else:
            chosen = candidates[0]
        # "demoted" means a CHEAPER variant exists but was skipped for
        # being soft-degraded/breaker-open — the documented health
        # demotion.  Skipping a healthy cheaper variant because its
        # rolling p99 misses the hint is ordinary SLO routing and must
        # not page anyone watching the demotions counter.
        admitted = set(id(g) for g in candidates)
        demoted = any(id(g) not in admitted
                      for g in groups[:groups.index(chosen)])
        if declared is not None and chosen.variant in declared:
            # a cheaper DECLARED variant that is not resident is demoted
            # the same way a breaker-open one is — the request lands on
            # a resident sibling instead of failing, and a background
            # promote nudges the missing variant back toward residency
            resident_variants = {g.variant for g in groups}
            missing = [v for v in declared[:declared.index(chosen.variant)]
                       if v not in resident_variants]
            for v in missing:
                self.cache.nudge_promote(model, variant=v)
            demoted = demoted or bool(missing)
        return chosen, self._done(model, chosen, groups, pinned=False,
                                  slo_ms=hint, slo_met=slo_met,
                                  demoted=demoted)

    def _done(self, model: str, chosen: VariantGroup,
              groups: List[VariantGroup], pinned: bool,
              slo_ms: Optional[float], slo_met: bool = True,
              demoted: bool = False) -> dict:
        with self._lock:
            k = (model, chosen.variant)
            self._routed[k] = self._routed.get(k, 0) + 1
            if demoted:
                self._demotions[model] = self._demotions.get(model, 0) + 1
            if not slo_met:
                self._slo_misses[model] = self._slo_misses.get(model, 0) + 1
        d = {"variant": chosen.variant, "demoted": demoted}
        if pinned:
            d["pinned"] = True
        if slo_ms is not None:
            d["slo_ms"] = slo_ms
            d["slo_met"] = slo_met
        return d

    # -- reporting ---------------------------------------------------------
    def routed(self, model: str, variant: str) -> int:
        with self._lock:
            return self._routed.get((model, variant), 0)

    def demotions(self, model: str) -> int:
        with self._lock:
            return self._demotions.get(model, 0)

    def section(self, model: str) -> dict:
        """The per-model ``router`` dict in stats/health."""
        groups = self.pool.variant_groups(model)
        with self._lock:
            return {
                "order": [g.variant for g in groups],
                "routed": {g.variant: self._routed.get((model, g.variant), 0)
                           for g in groups},
                "demotions": self._demotions.get(model, 0),
                "slo_misses": self._slo_misses.get(model, 0),
                "default_slo_ms": self.default_slo_ms or None,
                "strict": self.strict,
            }
