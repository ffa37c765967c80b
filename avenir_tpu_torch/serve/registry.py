"""Model registry: named+versioned online models with warmup and hot swap.

Configuration surface (all in the one ``serve.properties`` the CLI loads;
see resource/serving/ for a complete runbook):

    serve.models=churn,segments            # models to load at startup
    serve.model.<name>.kind=naiveBayes|nearestNeighbor|markovClassifier|decisionTree
    serve.model.<name>.version=1           # optional, default "1"
    serve.model.<name>.conf=<job.properties>   # the model's OWN job config
    serve.model.<name>.<key>=<value>       # inline overrides of that config
    serve.model.<name>.variants=f32,f64    # scorer variants, cheapest first
    serve.model.<name>.variant.<v>.<key>=<value>   # per-variant overlay
    serve.model.<name>.variant.<v>.latency.class=fast|standard
    serve.model.<name>.variant.<v>.accuracy.class=standard|parity

The reference's ``banditDecision`` kind is refused at load: it is not
ported yet (engine.UNPORTED_KINDS).

Variants (INFaaS-style, PAPERS.md) are alternative scorer builds of the
SAME artifact — ``f32``/``f64`` are built-in presets for the NB and
Markov kinds (engine.VARIANT_PRESETS) flipping the score precision; any other name
declares its config overlay explicitly.  The replica pool
(pool.py) builds N replicas per variant and the router (router.py)
picks per request.

A model's scoring config is exactly the properties file its batch
predictor job runs with (``bp.properties``, the Markov classifier's
config, ...), so one artifact + one config serves both the batch and the
online path.  Inline ``serve.model.<name>.*`` keys overlay the file —
e.g. pointing ``bayesian.model.file.path`` at a re-trained artifact
before a ``reload``.  Every adapter is built on an explicit
``torch.device``: the one ``build`` is given (the replica pool assigns
one per replica), else the registry's.

Entries are keyed (name, version); ``get(name)`` resolves the latest
loaded version.  ``reload`` builds a complete new adapter OFF-lock (model
files re-read, tables re-uploaded, nothing serves half-loaded state) and
swaps it in atomically; in-flight batches finish on the old adapter.
``warmup`` builds and runs every scorer once at the configured
power-of-two batch buckets on its device so steady-state traffic
triggers zero new builds (asserted via the ``Serve / Scorer
compilations`` counter).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from ..core import sanitizer
from ..core.config import JobConfig, parse_properties
from ..core.io import TornArtifactError
from ..core.metrics import Counters
from .engine import (VARIANT_PRESETS, ModelAdapter, ScorerCompileCache,
                     adapter_class, get_shared_tier, pow2_bucket,
                     pow2_buckets)

#: the implicit single variant of a model that declares none
DEFAULT_VARIANT = "default"

#: models REGISTERED to the managed model cache (serve/modelcache.py):
#: cold catalog descriptors, NOT built or device-resident at startup —
#: the decoupling of *registered* from *resident* (README "Multi-tenant
#: model multiplexing").  ``serve.models`` keeps its eager always-
#: resident semantics.
KEY_CACHE_MODELS = "serve.cache.models"

#: force the process-shared compile tier on/off; unset, the tier is on
#: exactly when the model cache is active (cataloged models share
#: compiled scorers by shape signature — engine.SharedCompileTier)
KEY_COMPILE_SHARED = "serve.cache.compile.shared"


class ModelDescriptor:
    """A cataloged model's COLD registration: everything needed to
    admit/promote it later without holding any device state — the
    registry keeps thousands of these while only the model cache's
    resident set owns adapters."""

    __slots__ = ("name", "kind", "variants", "fingerprint")

    def __init__(self, name: str, kind: str, variants: List[str],
                 fingerprint: str):
        self.name = name
        self.kind = kind
        self.variants = variants
        self.fingerprint = fingerprint


class ModelEntry:
    __slots__ = ("name", "version", "kind", "adapter", "counters",
                 "variant", "latency_class", "accuracy_class")

    def __init__(self, name: str, version: str, kind: str,
                 adapter: ModelAdapter, counters: Counters,
                 variant: str = DEFAULT_VARIANT,
                 latency_class: str = "standard",
                 accuracy_class: str = "standard"):
        self.name = name
        self.version = version
        self.kind = kind
        self.adapter = adapter
        self.counters = counters
        self.variant = variant
        self.latency_class = latency_class
        self.accuracy_class = accuracy_class


class ModelRegistry:
    """Loads/holds the online models; thread-safe lookup + hot swap."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = device
        self.max_batch = config.get_int("serve.batch.max.size", 64)
        buckets = config.get("serve.warmup.buckets")
        self.warmup_buckets = (
            sorted({pow2_bucket(int(v)) for v in buckets.split(",")})
            if buckets else pow2_buckets(self.max_batch))
        self._lock = sanitizer.make_lock("serve.registry")
        self._entries: Dict[Tuple[str, str], ModelEntry] = {}
        self._latest: Dict[str, str] = {}
        # the process-shared compile tier (multi-tenant compile reuse):
        # on when the model cache is active, overridable explicitly
        shared = config.get(KEY_COMPILE_SHARED)
        if shared is not None:
            use_tier = str(shared).strip().lower() == "true"
        else:
            use_tier = bool(config.get(KEY_CACHE_MODELS))
        self.compile_tier = get_shared_tier() if use_tier else None

    # -- configuration -----------------------------------------------------
    def model_names(self) -> List[str]:
        names = self.config.get("serve.models")
        if not names:
            return []
        return [n.strip() for n in names.split(",") if n.strip()]

    def cached_model_names(self) -> List[str]:
        """Models registered to the managed cache (cold catalog entries;
        ``serve.cache.models``) — disjoint use from the eager
        ``serve.models`` list, whose entries stay resident forever."""
        names = self.config.get(KEY_CACHE_MODELS)
        if not names:
            return []
        return [n.strip() for n in names.split(",") if n.strip()]

    def describe_all(self, names: List[str]) -> Dict[str, ModelDescriptor]:
        """Catalog descriptors for many models sharing ONE parsed-conf
        memo: a 1,000-tenant fleet whose entries point at the same
        ``conf`` properties file parses it once, not per tenant."""
        memo: Dict[str, Dict[str, str]] = {}
        return {n: self.describe(n, _conf_memo=memo) for n in names}

    def describe(self, name: str,
                 _conf_memo: Optional[Dict[str, Dict[str, str]]] = None
                 ) -> ModelDescriptor:
        """The model's cold catalog descriptor: declared kind + variant
        presets + a fingerprint over its resolved base config (artifact
        paths included) — no artifact is read, no device state built."""
        props = self._base_props(name, conf_memo=_conf_memo)
        kind = props.get("kind")
        if not kind:
            raise KeyError(f"missing serve.model.{name}.kind")
        adapter_class(kind)         # an unknown or unported kind raises
        digest = hashlib.sha1(
            repr(sorted(props.items())).encode()).hexdigest()[:16]
        return ModelDescriptor(name, kind, self.variant_names(name), digest)

    def variant_names(self, name: str) -> List[str]:
        """The model's declared scorer variants in COST ORDER (cheapest
        first — the order the router tries them in), or the implicit
        single ``default`` variant when none are declared."""
        v = self.config.get(f"serve.model.{name}.variants")
        if not v:
            return [DEFAULT_VARIANT]
        names = [s.strip() for s in v.split(",") if s.strip()]
        if not names:
            return [DEFAULT_VARIANT]
        if len(set(names)) != len(names):
            raise ValueError(
                f"duplicate variant names in serve.model.{name}.variants")
        return names

    def _variant_spec(self, name: str, kind: str, variant: str) -> dict:
        """Config overlay + declared latency/accuracy classes for one
        variant: the kind's built-in preset (f32/f64) underneath any
        explicit ``serve.model.<name>.variant.<v>.*`` keys."""
        preset = VARIANT_PRESETS.get(kind, {}).get(variant, {})
        overlay = dict(preset.get("overlay", {}))
        lat = preset.get("latency_class", "standard")
        acc = preset.get("accuracy_class", "standard")
        prefix = f"serve.model.{name}.variant.{variant}."
        for k, v in self.config.props.items():
            if not k.startswith(prefix):
                continue
            sub = k[len(prefix):]
            if sub == "latency.class":
                lat = v
            elif sub == "accuracy.class":
                acc = v
            else:
                overlay[sub] = v
        if variant != DEFAULT_VARIANT and not overlay:
            raise ValueError(
                f"variant {variant!r} of model {name!r} declares no config "
                f"overlay: name a built-in preset "
                f"({', '.join(sorted(VARIANT_PRESETS.get(kind, {})) or '-')})"
                f" or set serve.model.{name}.variant.{variant}.<key> keys")
        return {"overlay": overlay, "latency_class": lat,
                "accuracy_class": acc}

    def _base_props(self, name: str,
                    conf_memo: Optional[Dict[str, Dict[str, str]]] = None
                    ) -> Dict[str, str]:
        """The model's job config before any variant overlay: its
        ``conf`` file (if named) under the inline ``serve.model.<n>.*``
        overrides, minus the ``variant.`` subtree.  ``conf_memo`` (the
        bulk-registration path only) caches parsed conf files across
        calls; adapter BUILDS always re-read — an operator edits the
        conf and ``reload``s, and must get the fresh bytes."""
        prefix = f"serve.model.{name}."
        vprefix = f"{prefix}variant."
        inline = {k[len(prefix):]: v for k, v in self.config.props.items()
                  if k.startswith(prefix) and not k.startswith(vprefix)}
        props: Dict[str, str] = {}
        conf_path = inline.pop("conf", None)
        if conf_path:
            parsed = (conf_memo.get(conf_path)
                      if conf_memo is not None else None)
            if parsed is None:
                with open(conf_path, "r") as fh:
                    parsed = parse_properties(fh.read())
                if conf_memo is not None:
                    conf_memo[conf_path] = parsed
            props.update(parsed)
        props.update(inline)
        return props

    def _model_config(self, name: str,
                      variant: str = DEFAULT_VARIANT) -> JobConfig:
        props = self._base_props(name)
        if variant != DEFAULT_VARIANT:
            kind = props.get("kind", "")
            props.update(self._variant_spec(name, kind, variant)["overlay"])
        return JobConfig(props)

    # -- loading / lookup --------------------------------------------------
    def build(self, name: str, variant: str = DEFAULT_VARIANT,
              counters: Optional[Counters] = None,
              device=None) -> ModelEntry:
        """Construct one complete serving entry (adapter + counters) for
        a model variant WITHOUT registering it — the replica pool builds
        one per replica, on that replica's ``device``, and adopts only
        the primary."""
        props = self._base_props(name)
        kind = props.get("kind")
        if not kind:
            raise KeyError(f"missing serve.model.{name}.kind")
        cls = adapter_class(kind)
        # one spec computation feeds both the config overlay and the
        # declared classes — they can never drift apart
        spec = self._variant_spec(name, kind, variant)
        if variant != DEFAULT_VARIANT:
            props.update(spec["overlay"])
        mconf = JobConfig(props)
        version = mconf.get("version", "1")
        counters = counters if counters is not None else Counters()
        try:
            adapter = cls(mconf, counters,
                          cache=ScorerCompileCache(counters,
                                                   tier=self.compile_tier),
                          max_bucket=pow2_bucket(self.max_batch),
                          device=device if device is not None
                          else self.device)
        except TornArtifactError as e:
            # manifest validation caught a half-published artifact: name
            # the model so a failed `reload` response is actionable — no
            # swap happened, the previously adopted version keeps serving
            raise TornArtifactError(
                f"model {name!r} variant {variant!r}: {e} "
                f"(the currently served version is unaffected)") from None
        return ModelEntry(name, version, kind, adapter, counters,
                          variant=variant,
                          latency_class=spec["latency_class"],
                          accuracy_class=spec["accuracy_class"])

    def adopt(self, entry: ModelEntry, warmup: bool = False) -> ModelEntry:
        """Register a built entry as the latest version of its model."""
        if warmup:
            self._warm(entry)
        with self._lock:
            self._entries[(entry.name, entry.version)] = entry
            self._latest[entry.name] = entry.version
        return entry

    def load(self, name: str, warmup: bool = False,
             counters: Optional[Counters] = None) -> ModelEntry:
        # slow part (build + warm) off-lock
        return self.adopt(self.build(name, counters=counters),
                          warmup=warmup)

    def load_all(self, warmup: bool = False) -> List[ModelEntry]:
        return [self.load(n, warmup=warmup) for n in self.model_names()]

    def reload(self, name: str) -> ModelEntry:
        """Hot swap: rebuild from the (possibly updated) artifact files and
        atomically replace the served entry.  The model's Counters carry
        over (cumulative requests/shed/compile history survives the swap;
        'Reloads' counts every swap)."""
        try:
            counters = self.get(name).counters
        except KeyError:
            counters = None
        entry = self.load(name, warmup=True, counters=counters)
        entry.counters.incr("Serve", "Reloads")
        return entry

    def get(self, name: str, version: Optional[str] = None) -> ModelEntry:
        with self._lock:
            v = version or self._latest.get(name)
            if v is None or (name, v) not in self._entries:
                raise KeyError(
                    f"model {name!r}"
                    + (f" version {version!r}" if version else "")
                    + " is not loaded")
            return self._entries[(name, v)]

    def entries(self) -> List[ModelEntry]:
        with self._lock:
            return [self._entries[(n, v)] for n, v in self._latest.items()]

    def drop(self, name: str) -> bool:
        """Forget a model's adopted entries (the model cache DEMOTE path:
        device state is released by the pool; the cold catalog descriptor
        — just config — survives, so the model stays registered and can
        be promoted again)."""
        with self._lock:
            had = self._latest.pop(name, None) is not None
            for key in [k for k in self._entries if k[0] == name]:
                del self._entries[key]
            return had

    # -- warmup ------------------------------------------------------------
    def _warm(self, entry: ModelEntry) -> None:
        for b in self.warmup_buckets:
            entry.adapter.warm(b)
        entry.counters.set("Serve", "Warmup buckets",
                           len(self.warmup_buckets))

    def warmup(self, name: Optional[str] = None) -> None:
        """Build and run the scorers once at every configured bucket (all
        models, or one)."""
        targets = [self.get(name)] if name else self.entries()
        for entry in targets:
            self._warm(entry)
