"""The port's data layer against the JAX package's: NRRD reading over every
encoding and scalar type the JAX tests cover, CSV stacks, import dispatch,
``Volume.as_torch`` and the procedural models.  Inputs are made with NumPy
from a seed; the results must be equal (both are the same NumPy code).
"""

import numpy as np
import pytest
import torch

from volumetric_renderer_tpu import models as jmodels
from volumetric_renderer_tpu.data import importer as jimporter
from volumetric_renderer_tpu.data import nrrd as jnrrd
from volumetric_renderer_torch import models as tmodels
from volumetric_renderer_torch.data import _native
from volumetric_renderer_torch.data import importer as timporter
from volumetric_renderer_torch.data import nrrd as tnrrd
from volumetric_renderer_torch.data.volume import Volume

DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32",
          "int64", "uint64", "float32", "float64"]
ENCODINGS = ["raw", "ascii", "hex", "gzip", "bzip2"]


def rand_volume(rng, dtype, shape=(3, 4, 5)):
    if np.issubdtype(np.dtype(dtype), np.floating):
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000),
                        size=shape).astype(dtype)


def assert_same_volume(got, want):
    assert got.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.vmin, got.vmax) == (want.vmin, want.vmax)
    assert got.dimensions == want.dimensions


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("encoding", ENCODINGS)
def test_read_nrrd_matches_jax(tmp_path, dtype, encoding):
    arr = rand_volume(np.random.default_rng(7), dtype)
    p = str(tmp_path / "t.nrrd")
    tnrrd.write_nrrd(p, arr, encoding=encoding)
    _, raw = jnrrd.read_nrrd_raw(p)   # the port's writer, the JAX reader
    np.testing.assert_array_equal(raw, arr)
    assert_same_volume(tnrrd.read_nrrd(p), jnrrd.read_nrrd(p))
    assert_same_volume(timporter.import_volume(p),
                       jimporter.import_volume(p))


@pytest.mark.parametrize("encoding", ["raw", "gzip", "ascii"])
def test_detached_header_matches_jax(tmp_path, encoding):
    arr = rand_volume(np.random.default_rng(8), "uint16")
    p = str(tmp_path / "t.nhdr")
    jnrrd.write_nrrd(p, arr, encoding=encoding, detached=True)
    assert_same_volume(timporter.import_volume(p),
                       jimporter.import_volume(p))


def test_nrrd_errors_match_jax(tmp_path):
    p = tmp_path / "bad.nrrd"
    p.write_bytes(b"NRRD0001\ntype: float\ndimension: 3\nsizes: 2 2 2\n"
                  b"encoding: raw\nendian: little\n\n" + b"\0" * 4)
    with pytest.raises(tnrrd.NrrdError):
        tnrrd.read_nrrd(str(p))
    with pytest.raises(timporter.VolumeImportError):
        timporter.import_volume(str(p))
    with pytest.raises(jimporter.VolumeImportError):
        jimporter.import_volume(str(p))


def test_csv_stack_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    paths = []
    for z in range(3):
        sl = rng.uniform(-5.0, 5.0, size=(4, 6)).round(3)
        path = tmp_path / f"s{z}.csv"
        path.write_text("\n".join(",".join(str(v) for v in row)
                                  for row in sl) + "\n")
        paths.append(str(path))
    assert_same_volume(timporter.import_volume(paths),
                       jimporter.import_volume(paths))
    (tmp_path / "bad.csv").write_text("1,2\n3\n")
    with pytest.raises(timporter.VolumeImportError):
        timporter.import_volume([str(tmp_path / "bad.csv")])


def _image_file(fmt, path, img):
    """``img`` (H, W) uint16 written as a 16-bit PGM or PNG."""
    h, w = img.shape
    if fmt == "pnm":
        path.write_bytes(b"P5\n%d %d\n65535\n" % (w, h)
                         + img.astype(">u2").tobytes())
        return
    import struct
    import zlib

    raw = np.zeros((h, 1 + 2 * w), np.uint8)      # filter 0 per row
    raw[:, 1:] = np.frombuffer(img.astype(">u2").tobytes(),
                               np.uint8).reshape(h, 2 * w)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("fmt", ["vtk", "pnm", "png"])
def test_image_formats_import_as_jax(tmp_path, fmt):
    """VTK, PNM and PNG volumes through ``import_volume``, by extension and
    by ``fmt``, equal to the JAX importer's and to the voxels written."""
    arr = rand_volume(np.random.default_rng(10), "uint16", (3, 4, 5))
    if fmt == "vtk":
        p = tmp_path / "v.vtk"
        p.write_bytes(b"# vtk DataFile Version 3.0\nv\nBINARY\n"
                      b"DATASET STRUCTURED_POINTS\nDIMENSIONS 5 4 3\n"
                      b"POINT_DATA 60\nSCALARS d unsigned_short 1\n"
                      b"LOOKUP_TABLE default\n" + arr.astype(">u2").tobytes())
        paths, want = str(p), arr.astype(np.float32)
    else:
        ext = "pgm" if fmt == "pnm" else "png"
        files = [tmp_path / f"s{z}.{ext}" for z in range(3)]
        for path, img in zip(files, arr):
            _image_file(fmt, path, img)
        paths = [str(f) for f in files]
        want = arr.astype(np.float32) / 65535.0
    got = timporter.import_volume(paths)
    assert_same_volume(got, jimporter.import_volume(paths))
    assert_same_volume(timporter.import_volume(paths, fmt=fmt), got)
    np.testing.assert_array_equal(got.data, want)
    with pytest.raises(timporter.VolumeImportError):
        timporter.import_volume(str(tmp_path / "v.xyz"))


def test_volume_as_torch_and_models_match_jax():
    pairs = [(tmodels.sphere(20), jmodels.sphere(20)),
             (tmodels.shells(16), jmodels.shells(16)),
             (tmodels.head_phantom(24, seed=5), jmodels.head_phantom(24, seed=5))]
    for got, want in pairs:
        assert_same_volume(got, want)
        t = got.as_torch()
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(want.as_jax()))
    with pytest.raises(ValueError):
        Volume.from_array(np.zeros((2, 2)))


def test_native_dir_is_the_repo_native_library():
    import os

    from volumetric_renderer_tpu.data import _native as jnative

    assert _native._native_dir() == jnative._native_dir()
    assert os.path.exists(os.path.join(_native._native_dir(), "volio.c"))
