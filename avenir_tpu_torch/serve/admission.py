"""Per-tenant token-bucket admission for the managed model cache.

The LRU in serve/modelcache.py is a shared resource: every cold-start
PROMOTE a tenant triggers can evict a sibling's resident replicas, so
one hot tenant thrashing between cold and resident (or an adversarial
client spraying cold tenants) would otherwise monopolize both the
promote workers and the residency budget.  This module is the fairness
gate the cache consults before ENQUEUING a promote: each tenant owns a
token bucket refilled at ``serve.cache.tenant.quota.rate`` tokens/sec
with burst capacity ``serve.cache.tenant.quota.burst``; a promote
attempt with an empty bucket gets a structured ``quota_exceeded``
response carrying a bounded ``retry_after_ms`` — no queue slot, no
eviction, no scorer time.  Requests to an already-RESIDENT tenant never
consume tokens (serving is not the scarce resource; promotion is).

Buckets live in a bounded LRU keyed by tenant so an adversarial stream
of unique tenant names cannot grow host memory without bound; an
evicted bucket re-admits at full burst, which only ever errs in the
tenant's favor.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional, Tuple

from ..core import sanitizer

KEY_QUOTA_RATE = "serve.cache.tenant.quota.rate"
KEY_QUOTA_BURST = "serve.cache.tenant.quota.burst"

DEFAULT_QUOTA_BURST = 4
#: bounded bucket map (least-recently-charged tenants evicted)
MAX_TRACKED_TENANTS = 8192


class QuotaExceeded(RuntimeError):
    """A tenant's promote quota is exhausted: the request gets a
    structured ``quota_exceeded`` response with ``retry_after_ms``
    instead of evicting residents / occupying a promote worker."""

    def __init__(self, message: str, retry_after_ms: int):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)


class TenantAdmission:
    """Token buckets per tenant; thread-safe (charged from I/O shard and
    command threads concurrently)."""

    def __init__(self, rate: float, burst: int,
                 max_tenants: int = MAX_TRACKED_TENANTS):
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self.max_tenants = max(1, int(max_tenants))
        self._lock = sanitizer.make_lock("serve.cache.admission")
        #: tenant -> (tokens, last_refill_monotonic)
        self._buckets: "OrderedDict[str, Tuple[float, float]]" = \
            OrderedDict()
        self.rejected = 0

    @classmethod
    def from_config(cls, config) -> Optional["TenantAdmission"]:
        """None when quota is disabled (``serve.cache.tenant.quota.rate``
        absent or <= 0): every promote attempt admits."""
        rate = config.get_float(KEY_QUOTA_RATE, 0.0)
        if rate <= 0:
            return None
        return cls(rate, config.get_int(KEY_QUOTA_BURST,
                                        DEFAULT_QUOTA_BURST))

    def charge(self, tenant: str, now: Optional[float] = None) -> None:
        """Consume one promote token for ``tenant``; raises
        :class:`QuotaExceeded` (with the seconds-until-next-token as a
        bounded ``retry_after_ms``) when the bucket is empty."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            tokens, last = self._buckets.pop(tenant, (float(self.burst),
                                                      now))
            tokens = min(float(self.burst),
                         tokens + (now - last) * self.rate)
            if tokens < 1.0:
                # put the bucket back unchanged-but-refilled so repeat
                # offenders keep an accurate deficit
                self._buckets[tenant] = (tokens, now)
                self._trim()
                self.rejected += 1
                retry_ms = int(((1.0 - tokens) / self.rate) * 1000.0) + 1
                raise QuotaExceeded(
                    f"tenant {tenant!r} promote quota exhausted "
                    f"(serve.cache.tenant.quota.rate={self.rate}/s, "
                    f"burst={self.burst}); retry after {retry_ms}ms",
                    retry_ms)
            self._buckets[tenant] = (tokens - 1.0, now)
            self._trim()

    def _trim(self) -> None:
        while len(self._buckets) > self.max_tenants:
            self._buckets.popitem(last=False)

    def tokens(self, tenant: str, now: Optional[float] = None) -> float:
        """Current token balance (full burst for an unseen tenant)."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if tenant not in self._buckets:
                return float(self.burst)
            tokens, last = self._buckets[tenant]
            return min(float(self.burst),
                       tokens + (now - last) * self.rate)

    def section(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "tracked_tenants": len(self._buckets),
                    "rejected": self.rejected}
