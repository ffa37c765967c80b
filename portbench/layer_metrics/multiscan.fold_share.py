"""Share of the traced ``multi`` commands' wall time in the shared
scan's fan-out to the folds: the union of the program's
``multiscan.fold`` spans (one a job with a device fold a chunk, on the
consuming thread), the host's time to queue each fold on the stream."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("multiscan.fold",))
