"""The streaming-decision tier: the port of ``avenir_tpu/stream``.

- :mod:`.posterior`: the per-(tenant, arm) posterior monoid (the fold,
  ``ArmPosterior``, the live ``PosteriorStore`` with its Thompson and UCB
  decide path, the store registry, and the shared-scan
  ``FeedbackFoldSpec``);
- :mod:`.consumer`: the exactly-once Redis-stream feedback consumer;
- :mod:`.service`: the ``python -m avenir_tpu_torch stream`` entry point.
"""
