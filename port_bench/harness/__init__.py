"""The harness's shared parts: finding a cell's files by name, weights from
the seed, the traced window and the statistics of a window."""
