"""The port's background subtraction dataset against the JAX `BSDataset`
(which uses Pillow, available here) on one JAX-written dataset of five
objects, one of them with a turned and an extra run, and one foreground
depth raised by 300-1000 mm in a band (depth differences past 255, which
the uint8 cast wraps): the same object split and samples in both modes,
and every item equal with augmentation on and off for the same seed (the
image within 1e-6, the label exactly)."""
import os

import numpy as np
import pytest

from autoposeestimation_tpu.data import bs_dataset as jbs
from autoposeestimation_tpu.data import loader as jloader
from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.data import bs_dataset, loader
from test_torch_seg_models import two_threads  # noqa: F401

IMAGE_ATOL = 1e-6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bs"))
    objects = [jsyn.SphereObject(f"o{i}", np.asarray([8.0 * i, 0.0, 30.0]),
                                 30.0, (200 - 30 * i, 40 + 30 * i, 40))
               for i in range(5)]
    jsyn.make_dataset(root, objects=objects,
                      cfg=jsyn.SynthConfig(n_viewpoints=4, noise=1.0))
    # o2 gets a turned run and an extra run (copies of its foreground): the
    # dataset takes the first foreground run and skips the extra one
    data = os.path.join(jio.data_dir(root), "o2")
    labels = os.path.join(jio.label_dir(root), "o2")
    for run in ("foreground180", "extra"):
        for src, dst in ((data, data), (labels, labels)):
            os.makedirs(os.path.join(dst, run))
            for fn in os.listdir(os.path.join(src, "foreground")):
                with open(os.path.join(src, "foreground", fn), "rb") as f:
                    blob = f.read()
                with open(os.path.join(dst, run, fn), "wb") as f:
                    f.write(blob)
    path = os.path.join(jio.data_dir(root), "o0", "foreground",
                        "000001.depth.png")
    depth = jio.read_depth(path).astype(np.int64)
    rows = np.arange(depth.shape[0])[:, None]
    raised = np.where((depth > 0) & (rows >= 40) & (rows < 80),
                      depth + 300 + 7 * (rows - 40) * 2, depth)
    jio.write_png(path, raised.astype(np.uint16))
    return root


def test_split_and_samples(root):
    for mode in ("train", "test"):
        want = jbs.BSDataset(root, mode=mode)
        got = bs_dataset.BSDataset(root, mode=mode)
        assert got.samples == want.samples and len(got) > 0
        assert not any(run in ("extra", "background")
                       for _, run, _ in got.samples)
    train = bs_dataset.BSDataset(root, mode="train")
    test = bs_dataset.BSDataset(root, mode="test")
    assert not {o for o, _, _ in train.samples} & {o for o, _, _ in
                                                    test.samples}


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_items(root, mode, augment):
    want = jbs.BSDataset(root, mode=mode, seed=3, augment=augment)
    got = bs_dataset.BSDataset(root, mode=mode, seed=3, augment=augment)
    for i in range(len(want)):
        a, b = want[i], got[i]
        assert b["image"].dtype == np.float32 and b["label"].dtype == np.int32
        np.testing.assert_allclose(b["image"], a["image"], atol=IMAGE_ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(b["label"], a["label"])
        assert b["label"].sum() > 0


def test_wrapped_depth_difference(root):
    """The raised depth band reaches the item: its depth channel holds the
    wrapped differences, equal to the JAX item's."""
    want = jbs.BSDataset(root, mode="train", augment=False)
    got = bs_dataset.BSDataset(root, mode="train", augment=False)
    i = got.samples.index(("o0", "foreground", "000001"))
    np.testing.assert_allclose(got[i]["image"][..., 6],
                               want[i]["image"][..., 6], atol=IMAGE_ATOL,
                               rtol=0)
    assert len(np.unique(got[i]["image"][40:80, :, 6])) > 3


def test_loader_batches(root):
    """Test-mode batches through the port's Loader equal the JAX Loader's."""
    want = jbs.BSDataset(root, mode="test", augment=False)
    got = bs_dataset.BSDataset(root, mode="test", augment=False)
    for a, b in zip(jloader.Loader(want, 2, shuffle=False, drop_last=False),
                    loader.Loader(got, 2, shuffle=False, drop_last=False)):
        np.testing.assert_allclose(b["image"], a["image"], atol=IMAGE_ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(b["label"], a["label"])
