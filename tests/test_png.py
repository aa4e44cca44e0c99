"""The zlib PNG writer/reader (tyrant_tpu/utils/png.py) and the CLI's use
of it."""

import numpy as np
import pytest

from tyrant_tpu.utils.png import decode_png, encode_png, read_png, write_png


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 3), (7, 5, 4)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    back = read_png(str(path))
    want = img if img.ndim == 3 else img[:, :, None]
    np.testing.assert_array_equal(back, want)
    assert decode_png(encode_png(img)).shape == want.shape


def test_png_rejects_non_uint8():
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 3), np.float32))
