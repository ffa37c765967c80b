"""Share of the traced kNN pipelines' wall time in building and writing
the distance job's pair lines (the program's ``knn.emit`` spans)."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("knn.emit",))
