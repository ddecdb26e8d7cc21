"""The device memory's peak (torch.cuda.max_memory_allocated) over set-up
and the window of unroll requests, in GiB. Moves frames_per_s: a smaller
footprint lets more scenes share a request."""


def read(ctx):
    return ctx.peak_gib()
