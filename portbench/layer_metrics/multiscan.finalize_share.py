"""Share of the traced ``multi`` commands' wall time in the jobs'
finalizes after the shared scan: the union of the program's
``multiscan.finalize`` spans (one a job: the carry's copy back, the
job's statistics and its output file)."""

from harness.jobshare import job_share


def read(ctx):
    return job_share(ctx, ("multiscan.finalize",))
