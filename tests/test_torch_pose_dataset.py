"""The port's `PoseDataset` and `Loader` against the JAX package's on a
dataset the JAX `make_dataset` wrote (PIL-written PNGs, 160x128, depth
noise, one symmetric and one asymmetric object, an extra-sample list):
every key of every item equal, exactly, in test mode and in train mode
from the same seed (colour jitter and the RGB/L/I;16 rotations included),
with viewpoint subsampling, extra samples, `pose_source="meta_fields"` and
`return_raw`; Loader batches equal at 0 and 4 workers with `drop_last`
both ways."""
import os

import numpy as np
import pytest
import torch

from autoposeestimation_tpu.data import loader as jloader
from autoposeestimation_tpu.data import pose_dataset as jpd
from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.data import loader, pose_dataset

DS = "synth"


def objects():
    return [
        jsyn.SphereObject("ball", np.asarray([40.0, 0.0, 35.0]), 35.0,
                          (200, 40, 40), symmetric=1),
        jsyn.SphereObject("duo", np.asarray([-50.0, 30.0, 28.0]), 28.0,
                          (40, 60, 200), symmetric=0,
                          parts=((np.asarray([0.0, 25.0, 10.0]), 14.0,
                                  (230, 200, 30)),)),
    ]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The JAX package's dataset, plus an extra-sample list of every
    foreground view (label mode new_pred)."""
    base = str(tmp_path_factory.mktemp("pose_ds"))
    jsyn.make_dataset(base, objects=objects(),
                      cfg=jsyn.SynthConfig(n_viewpoints=10, noise=2.0))
    extra = [f"{o.name}/foreground/{vp:06d}" for o in objects()
             for vp in range(10)]
    jio.write_lines(os.path.join(jio.dataset_dir(base, "pose_estimation",
                                                 DS),
                                 "extra_train_data_list.txt"), extra)
    return base


def assert_items_equal(got, want, what):
    if want is None:
        assert got is None, what
        return
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        g = got[key]
        assert np.asarray(g).dtype == np.asarray(w).dtype, (what, key)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


def both(root, **kw):
    return (jpd.PoseDataset(root, DS, **kw),
            pose_dataset.PoseDataset(root, DS, **kw))


@pytest.mark.parametrize("num_pt", [200, 1000])
def test_test_mode_items_equal(root, num_pt):
    """num_pt 200 takes the stratified rank draw, 1000 the wrap-padding."""
    jds, pds = both(root, mode="test", num_pt=num_pt, num_pt_mesh=300)
    assert len(jds) == len(pds) > 0
    assert pds.get_sym_list() == jds.get_sym_list() == [0]
    for i in range(len(jds)):
        assert_items_equal(pds[i], jds[i], f"test item {i}")
    # the per-item stream: the same item twice is the same item
    assert_items_equal(pds[0], jds[0], "test item 0 again")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_pt=200, num_pt_mesh=1200, crop=64),
    dict(rot_degrees=30.0, noise_trans=0.01, label_mode="gen"),
], ids=["defaults", "stratified-wrapmesh-crop64", "narrow-rotation"])
def test_train_mode_items_equal(root, kw):
    """Train mode, items in order from one seed: colour jitter, the joint
    rotation, translation noise and the point draws consume the same
    streams in the same order."""
    jds, pds = both(root, mode="train", seed=3, **kw)
    for i in range(len(jds)):
        assert_items_equal(pds[i], jds[i], f"train item {i}")
    assert jds.rng.getstate() == pds.rng.getstate()


def test_viewpoints_extra_meta_fields_raw(root):
    kw = dict(mode="train", seed=5, p_viewpoints=0.5, p_extra_data=0.5,
              pose_source="meta_fields", return_raw=True, num_pt=300)
    jds, pds = both(root, **kw)
    assert pds.items == jds.items and pds.extra_items == jds.extra_items
    assert len(pds) == len(jds) > len(jds.items)
    for i in range(len(jds)):
        assert_items_equal(pds[i], jds[i], f"item {i}")
    jt, pt = both(root, mode="test", return_raw=True,
                  pose_source="meta_fields")
    for i in range(len(jt)):
        assert_items_equal(pt[i], jt[i], f"test raw item {i}")


def test_crop_and_zoom_waits_for_its_resize(root):
    with pytest.raises(NotImplementedError, match="Queue 1"):
        pose_dataset.PoseDataset(root, DS, crop_and_zoom=True)


@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal(root, workers, drop_last):
    jds, pds = both(root, mode="test", num_pt=128, num_pt_mesh=100,
                    return_raw=True)
    for shuffle in (True, False):
        jl = jloader.Loader(jds, 3, shuffle=shuffle, drop_last=drop_last,
                            seed=9, num_workers=workers)
        pl = loader.Loader(pds, 3, shuffle=shuffle, drop_last=drop_last,
                           seed=9, num_workers=workers)
        assert len(pl) == len(jl)
        want, got = list(jl), list(pl)
        assert len(got) == len(want) > 0
        if not drop_last:
            assert len(want[-1]["img"]) == len(jds) % 3
        for k, (g, w) in enumerate(zip(got, want)):
            assert_items_equal(g, w, f"batch {k}")


def test_device_prefetch_cpu_keeps_batches(root):
    """Off the card `device_prefetch` hands the Loader's batches on as
    tensors, values and dtypes kept."""
    _, pds = both(root, mode="test", num_pt=64, num_pt_mesh=32)
    want = list(loader.Loader(pds, 4, shuffle=False, drop_last=False,
                              num_workers=0))
    got = list(loader.device_prefetch(iter(want), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, val in w.items():
            assert isinstance(g[key], torch.Tensor)
            np.testing.assert_array_equal(g[key].numpy(), val)
            assert g[key].numpy().dtype == val.dtype
