"""The training steps' share of the bf16 peak: the frozen FLOPs of each
step kind times the steps of that kind in the window, over its seconds.
None where a kind of the window has no count."""
from harness.readers import mfu_pct


def read(ctx):
    kinds = ctx.window.get("kinds", {})
    if any(f"{kind}_step" not in ctx.flops for kind in kinds):
        return None
    flops = sum(ctx.flops[f"{kind}_step"] * n for kind, n in kinds.items())
    return mfu_pct(ctx, flops)
