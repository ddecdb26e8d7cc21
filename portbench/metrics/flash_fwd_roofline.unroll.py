"""The hand attention forward's (csrc/flash_attention_fwd.cu) share of its
roofline over a traced session of unroll requests: the calls' summed
bound, each the larger of 4 B S^2 C FLOPs over 989 TFLOP/s and its bytes
(q, k, v read, out and lse written, once each) over 3.35 TB/s, over their
summed device time. Moves frames_per_s."""


def read(ctx):
    return ctx.roofline("flash_fwd")
