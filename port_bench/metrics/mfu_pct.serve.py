"""The frame graph's share of the bf16 peak: the configuration's frozen
FLOPs a frame times the frames of the window, over its seconds. None where
the configuration has no count of a frame."""
from harness.readers import mfu_pct


def read(ctx):
    if "frame" not in ctx.flops:
        return None
    return mfu_pct(ctx, ctx.flops["frame"] * ctx.window["units"])
