"""The device memory's peak (torch.cuda.max_memory_allocated) over set-up
and the window of training steps, in GiB. Moves train_images_per_s: a
smaller footprint allows a larger batch."""


def read(ctx):
    return ctx.peak_gib()
