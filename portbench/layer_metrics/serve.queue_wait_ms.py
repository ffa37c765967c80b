"""Mean time a request waited in a micro-batcher's queue: the program's
``serve.queue.wait`` spans of single requests (those carrying a trace
id; without them, the batches' spans, each its oldest request's wait),
in ms."""


def read(ctx):
    spans = ctx.named("serve.queue.wait")
    mine = [s for s in spans if "trace" in s.attrs] or spans
    if not mine:
        return None
    return sum(s.dur_ns for s in mine) / len(mine) / 1e6
