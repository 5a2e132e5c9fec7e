"""staging_ms.serve: host milliseconds a batch spent in the benchmark's
span around the program's staging call (the port's
`preprocess_images` for frames; the copy of the crops to the card),
the mean over every batch of the traced window.  Program span."""


def read(ctx):
    stage = ctx.spans.get("stage")
    if not stage:
        return None
    return sum(stage) / len(stage) * 1e3
