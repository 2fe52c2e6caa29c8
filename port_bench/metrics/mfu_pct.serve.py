"""The frame graph's share of the bf16 peak: the configuration's frozen
FLOPs a frame times the frames of the window, over its seconds."""
from harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, ctx.flops["frame"] * ctx.window["units"])
