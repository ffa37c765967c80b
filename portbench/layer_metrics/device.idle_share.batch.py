"""1 - the union of the device's kernel, copy and set intervals in the
``torch.profiler`` trace over the batch window."""


def read(ctx):
    return ctx.idle_share()
