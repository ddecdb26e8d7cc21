"""The whole unroll's share of the card's bf16 peak: the model FLOPs of a
frame (encode, codeword search, decode, counted on the frozen reference,
portbench/work.py) times the frames the measured window made, over its
seconds and 989 TFLOP/s. Moves frames_per_s."""


def read(ctx):
    return ctx.mfu_pct()
