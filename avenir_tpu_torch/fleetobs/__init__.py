"""Fleet observability: the port's copy of the publisher half of
``avenir_tpu/fleetobs``.

With ``fleetobs.spool.dir`` set, the serve entry point atomically
publishes its ``TelemetryExporter`` snapshot per tick into a per-process
spool directory, tagged with a process identity record (:mod:`.identity`:
role, host, pid, start-time nonce, trace epoch anchor).  The reference's
aggregator, trace stitcher and incident bundler read those spools; they
are not ported.
"""

from __future__ import annotations

from .identity import ProcessIdentity, new_identity
from .publisher import SpoolPublisher, publisher_for_job

__all__ = ["ProcessIdentity", "SpoolPublisher", "new_identity",
           "publisher_for_job"]
