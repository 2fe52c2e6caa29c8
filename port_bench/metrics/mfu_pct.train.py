"""The training steps' share of the bf16 peak: the frozen FLOPs of each
step kind times the steps of that kind in the window, over its
seconds."""
from harness.readers import mfu_pct


def read(ctx):
    kinds = ctx.window.get("kinds", {})
    flops = sum(ctx.flops[f"{kind}_step"] * n for kind, n in kinds.items())
    return mfu_pct(ctx, flops)
