"""Share of the traced kNN pipelines' wall time in the distance job's
distance call: the operands' upload, K3, its merge K3m and the copy back
(the program's ``knn.distance`` spans)."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("knn.distance",))
