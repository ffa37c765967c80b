"""Shared small utilities (cache bounding, etc.)."""

from .caches import bounded_cache_get, bounded_cache_put

__all__ = ["bounded_cache_get", "bounded_cache_put"]
