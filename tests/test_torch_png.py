"""The port's PNG codec and text writers against PIL and the JAX package's
io: decoded pixels must be equal, written text byte-identical."""
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.utils import io, png


def row_filters(path):
    """The set of row filter types of a non-interlaced PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, height = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            height = struct.unpack(">I", data[pos + 12:pos + 16])[0]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw[::len(raw) // height].tolist())


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    """Two views of the synthetic scene, written by the JAX package (PIL)."""
    root = str(tmp_path_factory.mktemp("pngds"))
    jsyn.make_dataset(root, cfg=jsyn.SynthConfig(n_viewpoints=2))
    return root


def test_reader_matches_pil_on_dataset_images(jax_dataset):
    filters = set()
    n_files = 0
    for dirpath, _, files in os.walk(jax_dataset):
        for fn in files:
            if not fn.endswith(".png"):
                continue
            path = os.path.join(dirpath, fn)
            if fn.endswith(".color.png"):
                got, want = io.read_color(path), jio.read_color(path)
            elif fn.endswith(".depth.png"):
                got, want = io.read_depth(path), jio.read_depth(path)
            else:
                got, want = io.read_label(path), jio.read_label(path)
            assert got.dtype == want.dtype and np.array_equal(got, want), fn
            filters |= row_filters(path)
            n_files += 1
    # 2 objects: 2 runs x 2 views x (colour, depth), 2 views x 3 label modes
    assert n_files == 2 * (2 * 2 * 2 + 2 * 3)
    # PIL's encoder picks Sub, Up and Paeth on these images
    assert {1, 2, 4} <= filters, filters


def filter_mix_image(kind, rng):
    """Rows that make PIL's per-row choice land on None (noise), Sub
    (ramps), Up (repeated rows) and Paeth (a smooth 2-D field)."""
    i, j = np.mgrid[:48, :48].astype(np.float64)
    img = 128 + 1.5 * (i - j) + rng.normal(size=(48, 48))
    img = np.where(i % 6 == 0, rng.integers(0, 256, (48, 48)), img)
    img = np.where(i % 6 == 1, 20 + 4 * j, img)
    img[3::6] = img[2::6]
    if kind == "L":
        return np.clip(img, 0, 255).astype(np.uint8)
    if kind == "I;16":
        return np.clip(img * 200, 0, 65535).astype(np.uint16)
    chans = 3 if kind == "RGB" else 4
    return np.clip(np.stack([img + 9 * c for c in range(chans)], -1),
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["L", "I;16", "RGB", "RGBA"])
def test_reader_matches_pil_on_every_filter_pil_writes(kind, tmp_path):
    arr = filter_mix_image(kind, np.random.default_rng(0))
    path = str(tmp_path / "mix.png")
    Image.fromarray(arr).save(path)
    # PIL's adaptive filter never chose Average (3) on any image tried;
    # test_reader_handles_all_five_filters covers it with a hand-filtered file
    assert {0, 1, 2, 4} <= row_filters(path)
    got = png.read(path)
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    assert np.array_equal(got, np.asarray(Image.open(path)).astype(arr.dtype))


def filter_rows(raw: np.ndarray, bpp: int, ftypes) -> bytes:
    """Reference PNG filtering (the spec's formulas, one byte at a time)."""
    out = bytearray()
    prior = np.zeros(raw.shape[1], np.int64)
    for row, ft in zip(raw.astype(np.int64), ftypes):
        filt = []
        for x in range(len(row)):
            a = row[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ft]
            filt.append((row[x] - pred) % 256)
        out += bytes([ft]) + bytes(filt)
        prior = row
    return bytes(out)


@pytest.mark.parametrize("kind", ["L", "I;16", "RGB"])
def test_reader_handles_all_five_filters(kind, tmp_path):
    """A file whose rows cycle through None, Sub, Up, Average and Paeth,
    filtered by the reference formulas; PIL must read it the same way."""
    arr = filter_mix_image(kind, np.random.default_rng(1))[:20, :24]
    header = png.encode(arr)                # the IHDR of this image
    ihdr = header[8:8 + 25]
    rows = (arr.astype(">u2") if arr.dtype == np.uint16 else arr)
    raw = np.ascontiguousarray(rows).view(np.uint8).reshape(len(arr), -1)
    bpp = raw.shape[1] // arr.shape[1]
    body = zlib.compress(filter_rows(raw, bpp, [r % 5 for r in range(
        len(arr))]))
    data = (header[:8] + ihdr + struct.pack(">I", len(body)) + b"IDAT"
            + body + struct.pack(">I", zlib.crc32(b"IDAT" + body))
            + header[-12:])
    path = tmp_path / "five.png"
    path.write_bytes(data)
    got = png.decode(data)
    assert row_filters(str(path)) == {0, 1, 2, 3, 4}
    assert np.array_equal(got, arr)
    assert np.array_equal(np.asarray(Image.open(path)).astype(arr.dtype), arr)


@pytest.mark.parametrize("kind", ["L", "I;16", "RGB"])
def test_writer_read_back_by_pil(kind, tmp_path):
    arr = filter_mix_image(kind, np.random.default_rng(2))
    path = str(tmp_path / "out.png")
    io.write_png(path, arr)
    back = np.asarray(Image.open(path))
    assert np.array_equal(back.astype(arr.dtype), arr)
    assert row_filters(path) == {0}


def test_text_formats_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    cloud = rng.normal(size=(50, 3)) * 100
    cloud[:3] = [[0.0, -0.0, 1e-12], [1e10, -3.5, 7.0], [1 / 3, 2 / 3, 1.0]]
    for name, ours, theirs in (
            ("c.ply", io.write_ply, jio.write_ply),
            ("c.pcd", io.write_pcd, jio.write_pcd),
            ("c.xyz", io.write_xyz, jio.write_xyz),
            ("c32.xyz", lambda p, c: io.write_xyz(p, c.astype(np.float32)),
             lambda p, c: jio.write_xyz(p, c.astype(np.float32)))):
        ours(str(tmp_path / "port" / name), cloud)
        theirs(str(tmp_path / "jax" / name), cloud)
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        assert a == b, name
    np.testing.assert_array_equal(io.read_ply(str(tmp_path / "port/c.ply")),
                                  jio.read_ply(str(tmp_path / "port/c.ply")))
    np.testing.assert_array_equal(io.read_pcd(str(tmp_path / "port/c.pcd")),
                                  jio.read_pcd(str(tmp_path / "port/c.pcd")))


def test_meta_json_byte_identical(jax_dataset, tmp_path):
    meta_path = os.path.join(jio.data_dir(jax_dataset), "red_ball",
                             "foreground", "000001.meta.json")
    ours, theirs = io.read_sample_meta(meta_path), jio.read_sample_meta(
        meta_path)
    assert ours["intr"].to_dict() == theirs["intr"].to_dict()
    np.testing.assert_array_equal(io.robot2cam_from_meta(ours),
                                  jio.robot2cam_from_meta(theirs))
    io.write_sample_meta(str(tmp_path / "a.json"), ours)
    jio.write_sample_meta(str(tmp_path / "b.json"), theirs)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    rot = np.eye(3)[[1, 2, 0]]
    args = ([1.5, -2.0, 3.25], rot, "red_ball", np.eye(4) * 2, np.eye(4))
    io.write_pose_label_meta(str(tmp_path / "p.json"), *args)
    jio.write_pose_label_meta(str(tmp_path / "q.json"), *args)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "q.json").read_bytes()
    got = io.read_pose_label_meta(str(tmp_path / "p.json"))
    want = jio.read_pose_label_meta(str(tmp_path / "p.json"))
    for key in ("position", "rotation", "cam2robot", "robot2object"):
        np.testing.assert_array_equal(got[key], want[key])
    run = os.path.join(jio.data_dir(jax_dataset), "red_ball", "foreground")
    assert io.list_sample_ids(run) == jio.list_sample_ids(run)
