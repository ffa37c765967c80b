"""1 - the union of the device's kernel, copy and set intervals in the
``torch.profiler`` trace over the serving window (from the load
generator's start to its last answer)."""


def read(ctx):
    return ctx.idle_share()
