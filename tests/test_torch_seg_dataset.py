"""The port's crop-and-zoom and segmentation dataset against Pillow and the
JAX package: `augment.crop`, `resize_bicubic` and `resize_nearest` equal
Pillow 12's `crop` and `resize` bit for bit ("RGB" and "L" bicubic, "L" and
"I;16" nearest; downscales, upscales, equal sizes, odd sizes, boxes past
the frame), `CropAndZoom.__call__` equals the JAX one over many labels and
seeds, and `SegmentationDataset` equals the JAX one key by key, in train
and test mode, with the ImageNet statistics and with its own, on a dataset
the JAX `make_dataset` wrote (160x128)."""
import io as _io
import random

import numpy as np
import pytest
from PIL import Image

from autoposeestimation_tpu.data import augment as jaug
from autoposeestimation_tpu.data import segmentation_dataset as jsd
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.data import augment as aug
from autoposeestimation_tpu_torch.data import loader
from autoposeestimation_tpu_torch.data import segmentation_dataset as sd
from test_torch_pose_dataset import assert_items_equal

DS = "synth"

SIZES = [  # (in h, w) -> (out h, w)
    ((480, 640), (480, 480)), ((128, 160), (64, 64)), ((37, 53), (48, 48)),
    ((240, 240), (480, 480)), ((479, 333), (480, 480)),
    ((481, 481), (480, 480)), ((50, 77), (13, 91)), ((7, 5), (64, 64)),
    ((96, 96), (96, 96)), ((100, 480), (480, 480)), ((1, 1), (5, 5)),
    ((64, 96), (64, 47)), ((61, 64), (32, 64)),
]


def pil_i16(depth):
    """`depth` as Pillow opens a 16-bit PNG ("I;16")."""
    buf = _io.BytesIO()
    Image.fromarray(depth).save(buf, format="PNG")
    buf.seek(0)
    im = Image.open(buf)
    assert im.mode == "I;16"
    return im


def frame(hw, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img[: h // 2] = (np.arange(w)[None, :, None] * 7 % 256).astype(np.uint8)
    label = ((rng.random((h, w)) > 0.5) * 255).astype(np.uint8)
    depth = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    return img, label, depth


@pytest.mark.parametrize("hw,out", SIZES, ids=[f"{a}-{b}" for a, b in SIZES])
def test_resizes_equal_pillow(hw, out):
    img, label, depth = frame(hw, hw[0] * 1000 + hw[1])
    size = (out[1], out[0])
    np.testing.assert_array_equal(
        aug.resize_bicubic(img, size),
        np.asarray(Image.fromarray(img, "RGB").resize(size)))
    np.testing.assert_array_equal(
        aug.resize_bicubic(label, size),
        np.asarray(Image.fromarray(label, "L").resize(size)))
    np.testing.assert_array_equal(
        aug.resize_nearest(label, size),
        np.asarray(Image.fromarray(label, "L").resize(size, Image.NEAREST)))
    got = aug.resize_nearest(depth, size)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(
        got, np.asarray(pil_i16(depth).resize(size, Image.NEAREST)))


def test_crop_equals_pillow():
    """Boxes inside, across every edge and wholly outside the frame."""
    img, label, depth = frame((40, 52), 1)
    rng = np.random.default_rng(2)
    for _ in range(60):
        l, u = rng.integers(-30, 60, 2)
        box = (int(l), int(u), int(l + rng.integers(1, 50)),
               int(u + rng.integers(1, 50)))
        np.testing.assert_array_equal(
            aug.crop(img, box), np.asarray(Image.fromarray(img).crop(box)))
        np.testing.assert_array_equal(
            aug.crop(label, box),
            np.asarray(Image.fromarray(label, "L").crop(box)))
        np.testing.assert_array_equal(
            aug.crop(depth, box), np.asarray(pil_i16(depth).crop(box)))


def blob_label(hw, rng):
    """An object mask: an ellipse of random size, place and aspect (tall,
    wide and round ones take the box's three branches), sometimes none."""
    h, w = hw
    label = np.zeros(hw, np.uint8)
    if rng.random() < 0.1:
        return label
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    ry, rx = rng.uniform(2, h / 2), rng.uniform(2, w / 2)
    yy, xx = np.mgrid[:h, :w]
    label[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 255
    return label


@pytest.mark.parametrize("hw,size", [((480, 640), 480), ((128, 160), 64),
                                     ((97, 131), 80), ((60, 80), 96)])
def test_crop_and_zoom_call_equals_jax(hw, size):
    rng = np.random.default_rng(hw[0])
    for seed in range(12):
        img, _, _ = frame(hw, seed)
        label = blob_label(hw, rng)
        jr, pr = random.Random(seed), random.Random(seed)
        want_i, want_l = jaug.CropAndZoom(size, rng=jr)(
            Image.fromarray(img, "RGB"), Image.fromarray(label, "L"))
        got_i, got_l = aug.CropAndZoom(size, rng=pr)(img, label)
        assert got_i.shape == (size, size, 3) and got_l.shape == (size, size)
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
        np.testing.assert_array_equal(got_l, np.asarray(want_l))
        assert jr.getstate() == pr.getstate()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("seg_ds"))
    jsyn.make_dataset(base, cfg=jsyn.SynthConfig(n_viewpoints=6, noise=2.0))
    return base


def both(root, **kw):
    return (jsd.SegmentationDataset(root, DS, **kw),
            sd.SegmentationDataset(root, DS, **kw))


@pytest.mark.parametrize("imagenet", [True, False])
@pytest.mark.parametrize("mode", ["test", "train"])
def test_items_equal(root, mode, imagenet):
    """Every item, in order from one seed: test mode the full frame, train
    mode jittered, rotated and cropped-and-zoomed to 96 pixels; with the
    dataset's own statistics (f64 accumulation) too."""
    jds, pds = both(root, mode=mode, use_imagenet_stats=imagenet,
                    output_size=96, seed=4, label_mode="pred")
    assert pds.classes == jds.classes and pds.items == jds.items
    np.testing.assert_array_equal(pds.mean, jds.mean)
    np.testing.assert_array_equal(pds.std, jds.std)
    assert len(pds) == len(jds) > 0
    for i in range(len(jds)):
        assert_items_equal(pds[i], jds[i], f"{mode} item {i}")
    assert jds.rng.getstate() == pds.rng.getstate()
    if mode == "train":
        assert pds[0]["image"].shape == (96, 96, 3)
    labels = {int(c) for i in range(len(pds)) for c in
              np.unique(pds[i]["label"])}
    assert labels <= {0, 1, 2} and len(labels) > 1


def test_class_ids_and_loader(root):
    """The 255 -> class remap by the stem's object, and Loader batches of
    the port's dataset in the JAX Loader's layout."""
    _, pds = both(root, mode="test")
    for i, stem in enumerate(pds.items):
        want = 1 + pds.classes.index(stem.split("/")[0])
        assert pds.class_id(stem) == want
        assert set(np.unique(pds[i]["label"])) <= {0, want}
    batches = list(loader.Loader(pds, 2, shuffle=False, drop_last=False,
                                 num_workers=0))
    assert batches[0]["image"].shape == (2, 128, 160, 3)
    assert batches[0]["image"].dtype == np.float32
    assert batches[0]["label"].dtype == np.int32
    assert sum(len(b["label"]) for b in batches) == len(pds)
