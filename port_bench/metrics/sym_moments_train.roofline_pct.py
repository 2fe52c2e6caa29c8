"""`csrc/sym_moments_train.cu`'s share of its roofline: the least time of
its launches from their shapes (counts/bounds.py, in the precision the
configuration trains in) over their device time in the trace."""
from counts.bounds import sym_moments_train_seconds

KERNEL = "sym_moments_train_kernel"


def read(ctx):
    launches, seconds = ctx.trace.kernel(KERNEL)
    if launches == 0 or seconds <= 0:
        return None
    cfg = ctx.cell.config
    t = cfg["train"]
    bound = sym_moments_train_seconds(
        t["batch_size"], cfg["num_points"], cfg["num_points_mesh"],
        "bf16" if t["sym_bf16"] else "f32")
    return 100.0 * bound * launches / seconds
