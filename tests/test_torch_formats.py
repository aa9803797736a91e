"""The port's PNM / PNG / VTK readers against the JAX package's
(``volumetric_renderer_tpu/data/formats.py``), on the files
``tests/test_formats.py`` writes and a few more: each file is read through
both packages and the results must be equal (``assert_array_equal``), and
equal to the values the file was built from.

Two files show defects of the JAX readers that the port fixes; there the
test asserts the port's right answer and that the JAX reader gets it
wrong:
* a BINARY legacy-VTK file without a LOOKUP_TABLE line whose data holds a
  line that reads ``SCALARS ...``: the JAX reader scans the data as header;
* an ASCII PBM (P1) with no whitespace between its digits: the JAX reader
  reads a run of digits as one number.
"""

import struct
import zlib

import numpy as np
import pytest

from volumetric_renderer_tpu.data import formats as jformats
from volumetric_renderer_tpu.data import importer as jimporter
from volumetric_renderer_torch.data import formats as tformats
from volumetric_renderer_torch.data import importer as timporter


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def write_png(path, arr, *, color=False, depth=8, filters=None):
    """PNG writer straight from the spec: gray or RGB, 8/16-bit, a filter
    type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) per row."""
    h, w = arr.shape[:2]
    nch = 3 if color else 1
    if depth == 8:
        flat = np.asarray(arr, np.uint8).reshape(h, w * nch)
    else:
        a16 = np.asarray(arr, np.uint16).reshape(h, -1)
        flat = np.zeros((h, w * nch * 2), np.uint8)
        flat[:, 0::2] = (a16 >> 8).astype(np.uint8)
        flat[:, 1::2] = (a16 & 0xFF).astype(np.uint8)
    bpp = nch * depth // 8
    raw = bytearray()
    prev = np.zeros(flat.shape[1], np.int64)
    for y, ft in enumerate(filters or [0] * h):
        row = flat[y].astype(np.int64)
        enc = row.copy()
        for x in range(len(row)):
            a = int(row[x - bpp]) if x >= bpp else 0
            b = int(prev[x])
            c = int(prev[x - bpp]) if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
            enc[x] = (row[x] - pred) & 0xFF
        raw.append(ft)
        raw.extend(enc.astype(np.uint8).tobytes())
        prev = row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2 if color else 0, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(bytes(raw)))
                     + chunk(b"IEND", b""))


def both_images(reader, path):
    """The image ``reader`` gives in both packages, checked equal."""
    got = getattr(tformats, reader)(str(path))
    want = getattr(jformats, reader)(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    return got


def both_volumes(path_or_paths):
    got = timporter.import_volume(path_or_paths)
    want = jimporter.import_volume(path_or_paths)
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.vmin, got.vmax) == (want.vmin, want.vmax)
    return got


def test_pgm_binary(tmp_path):
    img = np.arange(20, dtype=np.uint8).reshape(4, 5)
    p = tmp_path / "x.pgm"
    p.write_bytes(b"P5\n# comment\n5 4\n255\n" + img.tobytes())
    np.testing.assert_allclose(both_images("read_pnm_image", p),
                               img / 255.0, atol=1e-7)


def test_pgm_ascii_and_16bit(tmp_path):
    p = tmp_path / "a.pgm"
    p.write_bytes(b"P2\n3 2\n1000\n0 100 200\n300 999 1000\n")
    got = both_images("read_pnm_image", p)
    assert got.shape == (2, 3)
    np.testing.assert_allclose(
        got, np.asarray([[0, 100, 200], [300, 999, 1000]]) / 1000.0,
        atol=1e-6)
    img = np.asarray([[256, 65535]], np.uint16)
    b = tmp_path / "b.pgm"
    b.write_bytes(b"P5\n2 1\n65535\n" + img.astype(">u2").tobytes())
    np.testing.assert_allclose(both_images("read_pnm_image", b),
                               img / 65535.0, atol=1e-7)


@pytest.mark.parametrize("kind", ["P6", "P3"])
def test_ppm_color_luminance(tmp_path, kind):
    p = tmp_path / "c.ppm"
    pix = np.asarray([[[255, 0, 0], [0, 255, 0]]], np.uint8)
    body = (pix.tobytes() if kind == "P6"
            else " ".join(map(str, pix.ravel())).encode())
    p.write_bytes(kind.encode() + b"\n2 1\n255\n" + body)
    np.testing.assert_allclose(both_images("read_pnm_image", p),
                               [[0.2126, 0.7152]], atol=1e-4)


def test_pbm_bitmap(tmp_path):
    # P4: packed bits, 1 = black -> inverted to 0.0
    p = tmp_path / "d.pbm"
    p.write_bytes(b"P4\n10 1\n" + bytes([0b10110000, 0b01000000]))
    np.testing.assert_array_equal(both_images("read_pnm_image", p)[0],
                                  [0, 1, 0, 0, 1, 1, 1, 1, 1, 0])
    # P1 with whitespace between the digits: both readers agree
    q = tmp_path / "e.pbm"
    q.write_bytes(b"P1\n# c\n4 2\n1 0 1 1\n0 0 1 0\n")
    np.testing.assert_array_equal(both_images("read_pnm_image", q),
                                  [[0, 1, 0, 0], [1, 1, 0, 1]])


def test_pbm_ascii_digits_without_whitespace(tmp_path):
    """Netpbm: each 0/1 of a P1 body is one pixel, whitespace optional.
    The JAX reader reads ``1011`` as the number 1011."""
    want = np.asarray([[0, 1, 0, 0], [1, 1, 0, 1]], np.float32)
    p = tmp_path / "packed.pbm"
    p.write_bytes(b"P1\n4 2\n1011\n0010\n")
    np.testing.assert_array_equal(tformats.read_pnm_image(str(p)), want)
    with pytest.raises(ValueError, match="truncated"):
        jformats.read_pnm_image(str(p))       # 2 numbers, not 8 pixels
    # mixed: the JAX reader finds 4 numbers where 4 pixels are wanted, so
    # it returns an image, and a wrong one
    q = tmp_path / "mixed.pbm"
    q.write_bytes(b"P1\n2 2\n1 0\n11 0\n")
    np.testing.assert_array_equal(tformats.read_pnm_image(str(q)),
                                  [[0, 1], [0, 0]])
    assert not np.array_equal(jformats.read_pnm_image(str(q)),
                              tformats.read_pnm_image(str(q)))
    bad = tmp_path / "bad.pbm"
    bad.write_bytes(b"P1\n2 1\n12\n")
    with pytest.raises(ValueError, match="other than 0 and 1"):
        tformats.read_pnm_image(str(bad))


@pytest.mark.parametrize("filters", [[0, 1, 2, 0, 2, 1], [3, 4, 3, 4, 0, 4],
                                     [4, 3, 1, 2, 0, 1]])
def test_png_gray8_filters(tmp_path, filters):
    img = np.random.default_rng(0).integers(0, 256, (6, 7), dtype=np.uint8)
    p = tmp_path / "g.png"
    write_png(p, img, filters=filters)
    np.testing.assert_array_equal(both_images("read_png_image", p),
                                  img / np.float32(255.0))


@pytest.mark.parametrize("filters", [[0, 1], [3, 4], [2, 1]])
def test_png_rgb_and_16bit(tmp_path, filters):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, 5, 3), dtype=np.uint8)
    p = tmp_path / "rgb.png"
    write_png(p, img, color=True, filters=filters)
    lum = (img / np.float32(255.0) * np.asarray(
        [0.2126, 0.7152, 0.0722], np.float32)).sum(-1)
    np.testing.assert_allclose(both_images("read_png_image", p), lum,
                               atol=1e-6)
    g16 = rng.integers(0, 65536, (2, 5), dtype=np.uint16)
    q = tmp_path / "g16.png"
    write_png(q, g16, depth=16, filters=filters)
    np.testing.assert_array_equal(both_images("read_png_image", q),
                                  g16.astype(np.float32) / 65535.0)


def vtk_header(kind, scalars, lookup=True, dims=(4, 3, 2)):
    n = int(np.prod(dims))
    return ((b"# vtk DataFile Version 3.0\ntest\n" + kind + b"\n"
             b"DATASET STRUCTURED_POINTS\nDIMENSIONS %d %d %d\n" % dims
             + b"SPACING 1 1 1\nORIGIN 0 0 0\nPOINT_DATA %d\n" % n
             + scalars + b"\n")
            + (b"LOOKUP_TABLE default\n" if lookup else b""))


@pytest.mark.parametrize("vtype,dt", [("float", ">f4"), ("double", ">f8"),
                                      ("unsigned_short", ">u2"),
                                      ("short", ">i2"),
                                      ("unsigned_char", "u1")])
@pytest.mark.parametrize("lookup", [True, False])
def test_vtk_binary(tmp_path, vtype, dt, lookup):
    vol = np.arange(24, dtype=np.float32).reshape(2, 3, 4)  # z,y,x
    p = tmp_path / "v.vtk"
    p.write_bytes(vtk_header(b"BINARY", b"SCALARS density " + vtype.encode()
                             + b" 1", lookup) + vol.astype(dt).tobytes())
    got = both_volumes(str(p))
    np.testing.assert_array_equal(got.data, vol)
    assert got.vmin == 0.0 and got.vmax == 23.0


def test_vtk_ascii(tmp_path):
    vol = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    body = " ".join(str(int(v)) for v in vol.ravel())
    a = tmp_path / "a.vtk"
    a.write_bytes(
        b"# vtk DataFile Version 2.0\nt\nASCII\n"
        b"DATASET STRUCTURED_POINTS\nDIMENSIONS 4 3 2\nPOINT_DATA 24\n"
        b"SCALARS d unsigned_short\n" + body.encode())
    np.testing.assert_array_equal(both_volumes(str(a)).data, vol)
    # two components: the first is kept
    b = tmp_path / "b.vtk"
    two = np.stack([vol.ravel(), -vol.ravel()], axis=1)
    b.write_bytes(vtk_header(b"ASCII", b"SCALARS d float 2")
                  + " ".join(str(v) for v in two.ravel()).encode())
    np.testing.assert_array_equal(both_volumes(str(b)).data, vol)


def test_vtk_binary_body_is_not_read_as_header(tmp_path):
    """A BINARY file without LOOKUP_TABLE whose data holds the bytes
    ``\\nSCALARS d double\\n``: the port stops at the real SCALARS line;
    the JAX reader scans the data as header and takes the second one."""
    body = bytearray(np.arange(96, dtype=np.uint8).tobytes())
    trap = b"\nSCALARS d double\n"
    body[10:10 + len(trap)] = trap
    vol = np.frombuffer(bytes(body), np.uint8).reshape(4, 4, 6)
    p = tmp_path / "trap.vtk"
    p.write_bytes(vtk_header(b"BINARY", b"SCALARS d unsigned_char",
                             lookup=False, dims=(6, 4, 4)) + bytes(body))
    got = timporter.import_volume(str(p))
    np.testing.assert_array_equal(got.data, vol.astype(np.float32))
    with pytest.raises(ValueError, match="truncated"):
        jformats.read_vtk(str(p))       # 96 doubles past the fake line


def test_vtk_rejects_wrong_dataset(tmp_path):
    p = tmp_path / "bad.vtk"
    p.write_bytes(b"# vtk DataFile Version 3.0\nt\nASCII\n"
                  b"DATASET POLYDATA\n")
    for reader in (tformats.read_vtk, jformats.read_vtk):
        with pytest.raises(ValueError, match="STRUCTURED_POINTS"):
            reader(str(p))
    with pytest.raises(timporter.VolumeImportError):
        timporter.import_volume(str(p))


def test_import_volume_dispatch(tmp_path):
    img0 = np.asarray([[0, 128], [255, 64]], np.uint8)
    img1 = np.asarray([[1, 2], [3, 4]], np.uint8)
    for i, img in enumerate((img0, img1)):
        (tmp_path / f"s{i}.pgm").write_bytes(
            b"P5\n2 2\n255\n" + img.tobytes())
    v = both_volumes([str(tmp_path / "s0.pgm"), str(tmp_path / "s1.pgm")])
    assert v.data.shape == (2, 2, 2)
    np.testing.assert_array_equal(v.data[0], img0 / np.float32(255.0))

    write_png(tmp_path / "one.png", img0)
    assert both_volumes(str(tmp_path / "one.png")).data.shape == (1, 2, 2)
    v = timporter.import_volume([str(tmp_path / "one.png")] * 3, fmt="png")
    assert v.data.shape == (3, 2, 2)

    for importer in (timporter, jimporter):
        with pytest.raises(importer.VolumeImportError):
            importer.import_volume(str(tmp_path / "nope.xyz"))
        # stack with mismatched slice shapes -> import error
        (tmp_path / "s2.pgm").write_bytes(b"P5\n3 1\n255\n" + bytes(3))
        with pytest.raises(importer.VolumeImportError):
            importer.import_volume([str(tmp_path / "s0.pgm"),
                                    str(tmp_path / "s2.pgm")])
        with pytest.raises(importer.VolumeImportError, match="single"):
            importer.import_volume([str(tmp_path / "a.vtk")] * 2,
                                   fmt="vtk")
