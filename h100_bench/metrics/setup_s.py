"""setup_s: seconds from the process's start to the first timed batch:
imports, the card's start, the inputs and weights made from the seed,
the program's build (and, in a new checkout, its kernels' compile), the
warm-up.  Host clock."""


def read(ctx):
    return ctx.setup_s
