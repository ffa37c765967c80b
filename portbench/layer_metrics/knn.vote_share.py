"""Share of the traced kNN pipelines' wall time in the vote job's
decisions, confusion counts and prediction lines (the program's
``knn.vote`` spans; the grouping of the pair lines by test id runs in
the job's ``ingest.parse`` pass)."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("knn.vote",))
