"""The standard-library PNG writer the app saves its renders with."""

import numpy as np
import pytest

from topfusion.utils.png import decode_png, encode_png, read_png, write_png


@pytest.mark.parametrize("shape", [(30, 41), (30, 41, 3), (30, 41, 4)])
def test_png_decodes_to_the_same_pixels(tmp_path, shape):
    iio = pytest.importorskip("imageio.v3")
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(iio.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_png_readable_by_native_decoder(tmp_path):
    from topfusion.io.native_loader import decode_png_native, native_available

    if not native_available():
        pytest.skip("no C++ toolchain to build the native loader")
    img = np.random.default_rng(1).integers(0, 256, (17, 23, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(decode_png_native(path), img)


def test_png_rejects_non_uint8():
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((4, 4), np.float32))


def test_png_reader_refuses_filtered_scanlines():
    data = bytearray(encode_png(np.zeros((2, 3), np.uint8)))
    import struct
    import zlib

    # Re-encode the pixel data with filter type 1 (Sub) on every row.
    body = zlib.compress(bytes([1, 0, 0, 0] * 2))
    start = data.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", data[start:start + 4])
    chunk = (
        struct.pack(">I", len(body)) + b"IDAT" + body
        + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF)
    )
    data[start:start + 12 + n] = chunk
    with pytest.raises(ValueError, match="filtered"):
        decode_png(bytes(data))
