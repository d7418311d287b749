"""setup_s: seconds from the process's start to the window (importing
torch, reaching the card, loading or building the kernels, making the
inputs, the first steps and the warm-up), less the seconds of the
benchmark's own work in set-up: the plain reference's render of a fit's
targets and the copy of its first prediction to the host for the check,
each timed between two synchronizes."""


def read(ctx):
    return ctx.setup_s
