"""Acquisition data viewer: each color/depth pair of an object's run side
by side, shown with matplotlib or written as PNG panels.

    python -m autoposeestimation_tpu_torch.scripts.view_data ROOT OBJECT
        [RUN] [--dump-dir DIR]
"""
import argparse
import os

import numpy as np

from ..utils import io


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("root")
    parser.add_argument("object")
    parser.add_argument("run", nargs="?", default="foreground")
    parser.add_argument("--dump-dir", default=None)
    args = parser.parse_args(argv)

    run_dir = os.path.join(io.data_dir(args.root), args.object, args.run)
    for stem in io.list_sample_ids(run_dir):
        color = io.read_color(os.path.join(run_dir, stem + ".color.png"))
        depth = io.read_depth(os.path.join(run_dir, stem + ".depth.png"))
        dmax = max(float(depth.max()), 1.0)
        depth_vis = np.repeat((depth.astype(np.float64) / dmax * 255)
                              .astype(np.uint8)[..., None], 3, axis=-1)
        panel = np.concatenate([color, depth_vis], axis=1)
        if args.dump_dir:
            io.write_png(os.path.join(args.dump_dir, stem + ".panel.png"),
                         panel)
        else:
            import matplotlib.pyplot as plt

            plt.imshow(panel)
            plt.title(stem)
            plt.pause(0.5)


if __name__ == "__main__":
    main()
