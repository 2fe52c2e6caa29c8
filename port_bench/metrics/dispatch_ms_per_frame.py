"""Host ms a served frame takes to dispatch its work: the upload and the
frame graph's stages (`frame.upload` / `stream.upload` and `graph.*`; a
stream call's over its frames), in the first traced window."""
from harness.spans import ms_per_unit

SPANS = ("frame.upload", "stream.upload", "graph.segment", "graph.cca",
         "graph.crop", "graph.pose", "graph.refine")


def read(ctx):
    return ms_per_unit(ctx, SPANS)
