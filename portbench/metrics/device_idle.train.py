"""The device's idle share over the measured window of steps: 1 - the
device's busy time a step (the union of the card's record intervals in a
CUDA-only traced session, portbench/trace.py) times the window's steps,
over the window's seconds. The traced session's own host time runs longer
than the window's, by the profiler's cost a launch, so it is not the
base. Moves train_images_per_s."""


def read(ctx):
    return ctx.idle_pct()
