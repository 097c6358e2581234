"""The port's image path of the occupancy-map ingest, which reads no Pillow:
its PNG decoder and its copy of Pillow's bilinear reduce against Pillow,
and ``load_occ_map`` against the JAX package's (whose Pillow path is the
reference: the native raster pipeline is not built) bit for bit on all four
image maps at two sizes and balloon amounts. A test may import Pillow; the
port may not."""

import dataclasses
import os
import re
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from live_ekf_slam_tpu import native
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.sim import maps as jmaps
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.sim import maps as tmaps
from live_ekf_slam_tpu_torch.sim import png

MAPS = ("igvc1.png", "igvc2.png", "building1.png", "building2.png")


def _path(name):
    return os.path.join(tmaps.ASSET_DIR, name)


@pytest.mark.parametrize("name", MAPS)
def test_decoder_matches_pillow(name):
    got = png.read_png(_path(name))
    want = np.asarray(Image.open(_path(name)))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_the_maps_use_every_row_filter():
    # so that the decoder tests above cover all five
    seen = set()
    for name in MAPS:
        arr = np.asarray(Image.open(_path(name)))
        h, w, c = arr.shape
        with open(_path(name), "rb") as f:
            data = f.read()
        idat, pos = b"", 8
        while pos < len(data):
            (n,) = struct.unpack(">I", data[pos:pos + 4])
            if data[pos + 4:pos + 8] == b"IDAT":
                idat += data[pos + 8:pos + 8 + n]
            pos += 12 + n
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
        seen |= set(raw.reshape(h, w * c + 1)[:, 0].tolist())
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("size", [(150, 150), (64, 97), (400, 400)])
def test_resample_matches_pillow(name, size):
    rgb = np.ascontiguousarray(np.asarray(Image.open(_path(name)))[:, :, :3])
    want = np.asarray(Image.fromarray(rgb).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(png.resize_bilinear(rgb, *size), want)


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("size,amt", [(None, None), (100, 1)])
def test_load_occ_map_matches_jax(name, size, amt):
    assert not native.available()
    cfgs = []
    for cls in (JConfig, Config):
        cfg = cls().replace(occ_map_img=name)
        if size is not None:
            cfg = cfg.replace(map=dataclasses.replace(
                cfg.map, occ_map_size=size, occ_map_balloon_amt=amt))
        cfgs.append(cfg)
    j_occ, j_color = jmaps.load_occ_map(cfgs[0])
    occ, color = tmaps.load_occ_map(cfgs[1])
    s = cfgs[1].map.occ_map_size
    assert occ.shape == (s, s) and occ.dtype == j_occ.dtype == np.float32
    np.testing.assert_array_equal(occ, j_occ)
    np.testing.assert_array_equal(color, j_color)
    assert 0.05 < occ.mean() < 0.95


def _write_png(path, width, height, depth, color, interlace=0):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * max(depth // 8, 1)
    raw = b"".join(b"\x00" + bytes(width * bpp) for _ in range(height))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                             color, 0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,color,interlace,what", [
    (8, 0, 0, "8-bit grayscale"), (8, 3, 0, "8-bit palette"),
    (16, 2, 0, "16-bit RGB"), (8, 6, 1, "8-bit RGBA, interlaced"),
    (8, 4, 0, "8-bit grayscale+alpha")])
def test_unsupported_png_formats_raise(tmp_path, depth, color, interlace, what):
    path = tmp_path / "map.png"
    _write_png(path, 8, 8, depth, color, interlace)
    with pytest.raises(ValueError, match=re.escape(f"unsupported PNG format ({what})")):
        png.read_png(path)
    with pytest.raises(ValueError, match="unsupported PNG format"):
        tmaps.load_occ_map(Config().replace(occ_map_img=str(path)))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(_path("blank.jpg"))
