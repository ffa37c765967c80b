"""Mean time of one micro-batch's scoring: the program's ``serve.score``
spans (one a batch: encode, the scorer's graph replay, the output
lines), in ms."""


def read(ctx):
    spans = ctx.named("serve.score")
    if not spans:
        return None
    return sum(s.dur_ns for s in spans) / len(spans) / 1e6
