"""PNM / PNG / VTK readers — NrrdIO's other input formats.

The vendored NrrdIO in the reference can read PNM (``extern/NrrdIO/
formatPNM.c``), PNG (``formatPNG.c``) and VTK structured points
(``formatVTK.c``) in addition to NRRD (format enum ``NrrdIO.h:913-921``).
The reference *app* never exercises them (its parser requires ``dim == 3``
NRRD files, ``src/data/nrrd_file_parser.cpp:23-30``), but they are part of
the vendored library's capability set, so the framework carries
equivalents: each 2-D image becomes one Z-slice (a list of images stacks
into a volume, like the CSV slice stack), and VTK structured points load
as full 3-D volumes.

Pure NumPy + stdlib ``zlib``.  Color images collapse to luminance
(Rec.709) — the framework's ``Volume`` is scalar by contract
(``src/data/dataset.h:9-13``).

Two readings differ from the JAX package's readers
(``volumetric_renderer_tpu/data/formats.py``), which get these files wrong:

* ``read_vtk`` stops reading the header at the ``SCALARS`` line and its
  optional ``LOOKUP_TABLE`` line.  The JAX reader scans on, line by line,
  through the whole data section when ``LOOKUP_TABLE`` is absent, and a
  BINARY body whose bytes begin a line with ``DIMENSIONS`` or ``SCALARS``
  rewrites its header.
* An ASCII PBM (``P1``) holds one pixel per ``0``/``1`` digit, with or
  without whitespace between them (the Netpbm format); the JAX reader
  reads a run of digits as one number.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from volumetric_renderer_torch.data.volume import Volume

# ---------------------------------------------------------------------------
# PNM (PBM / PGM / PPM, ascii "P1-P3" and binary "P4-P6" variants)
# ---------------------------------------------------------------------------

_PNM_MAGICS = {b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"}


def _pnm_tokens(data: bytes):
    """Token stream over a PNM header/ascii body, skipping '#' comments."""
    i = 0
    n = len(data)
    while i < n:
        c = data[i:i + 1]
        if c.isspace():
            i += 1
        elif c == b"#":
            j = data.find(b"\n", i)
            i = n if j < 0 else j + 1
        else:
            j = i
            while j < n and not data[j:j + 1].isspace():
                j += 1
            yield i, data[i:j]
            i = j


def read_pnm_image(path: str) -> np.ndarray:
    """One PNM file -> float32 (H, W) image (formatPNM.c equivalent)."""
    with open(path, "rb") as f:
        data = f.read()
    toks = _pnm_tokens(data)
    try:
        _, magic = next(toks)
    except StopIteration:
        raise ValueError(f"{path}: empty PNM file")
    if magic not in _PNM_MAGICS:
        raise ValueError(f"{path}: not a PNM file (magic {magic!r})")
    kind = int(magic[1:])
    bitmap = kind in (1, 4)
    color = kind in (3, 6)
    nvals_header = 2 if bitmap else 3
    header: List[int] = []
    end = 0
    for pos, t in toks:
        header.append(int(t))
        end = pos + len(t)
        if len(header) == nvals_header:
            break
    if len(header) < nvals_header:
        raise ValueError(f"{path}: truncated PNM header")
    w, h = header[0], header[1]
    maxval = 1 if bitmap else header[2]
    if w <= 0 or h <= 0 or maxval <= 0 or maxval > 65535:
        raise ValueError(f"{path}: bad PNM geometry {w}x{h} maxval {maxval}")
    channels = 3 if color else 1

    if kind in (1, 2, 3):  # ascii
        need = w * h * channels
        if kind == 1:  # PBM: one pixel per digit, whitespace optional
            digits = b"".join(t for _, t in _pnm_tokens(data[end:]))
            if digits.translate(None, b"01"):
                raise ValueError(f"{path}: PBM data holds a character "
                                 "other than 0 and 1")
            vals = [d - ord("0") for d in digits]
        else:
            vals = [int(t) for _, t in _pnm_tokens(data[end:])]
        if len(vals) < need:
            raise ValueError(f"{path}: PNM data truncated "
                             f"({len(vals)} of {need} values)")
        arr = np.asarray(vals[:need], dtype=np.float32)
        if kind == 1:  # PBM: 1 = black
            arr = 1.0 - arr
    else:  # binary: exactly one whitespace byte after the header
        body = data[end + 1:]
        if kind == 4:
            stride = (w + 7) // 8
            need = stride * h
            if len(body) < need:
                raise ValueError(f"{path}: PBM data truncated")
            bits = np.unpackbits(
                np.frombuffer(body[:need], np.uint8).reshape(h, stride),
                axis=1)[:, :w]
            arr = (1.0 - bits).astype(np.float32)  # 1 = black
        else:
            dt = np.dtype(">u2" if maxval > 255 else np.uint8)
            need = w * h * channels * dt.itemsize
            if len(body) < need:
                raise ValueError(f"{path}: PNM data truncated "
                                 f"({len(body)} of {need} bytes)")
            arr = np.frombuffer(body[:need], dt).astype(np.float32)

    arr = arr.reshape(h, w, channels) if color else arr.reshape(h, w)
    arr = arr / float(maxval) if not bitmap else arr
    if color:
        arr = (arr * np.asarray([0.2126, 0.7152, 0.0722],
                                np.float32)).sum(axis=-1)
    return np.ascontiguousarray(arr, dtype=np.float32)


# ---------------------------------------------------------------------------
# PNG (critical chunks only; filters 0-4; no Adam7 interlace)
# ---------------------------------------------------------------------------

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse per-row PNG filtering (spec §6: None/Sub/Up/Average/Paeth).

    None, Sub and Up are whole-row operations (Sub is a running sum mod 256
    along each of the ``bpp`` byte lanes); Average and Paeth depend on the
    byte just reconstructed and run byte by byte."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                            np.uint8).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub
            lanes = np.zeros(-(-stride // bpp) * bpp, np.int64)
            lanes[:stride] = row
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0).reshape(-1)
                   [:stride] & 0xFF).astype(np.int32)
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = row.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = row.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                c = prev[x - bpp] if x >= bpp else 0
                b = prev[x]
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png_image(path: str) -> np.ndarray:
    """One PNG file -> float32 (H, W) image (formatPNG.c equivalent)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    ihdr = None
    idat = bytearray()
    while pos + 8 <= len(data):
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length + type + data + crc
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.extend(chunk)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG missing IHDR")
    w, h, depth, ctype_i, comp, filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG not supported")
    if comp or filt:
        raise ValueError(f"{path}: bad PNG compression/filter method")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype_i)
    if nch is None or depth not in (8, 16):
        raise ValueError(f"{path}: unsupported PNG color type {ctype_i} "
                         f"/ bit depth {depth} (gray/RGB(A), 8/16-bit)")
    raw = zlib.decompress(bytes(idat))
    bpp = nch * depth // 8
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG data size mismatch")
    flat = _png_unfilter(raw, h, stride, bpp)
    if depth == 16:
        arr = flat.reshape(h, w, nch, 2).astype(np.uint16)
        arr = ((arr[..., 0] << 8) | arr[..., 1]).astype(np.float32) / 65535.0
    else:
        arr = flat.reshape(h, w, nch).astype(np.float32) / 255.0
    if ctype_i == 0:
        arr = arr[..., 0]
    elif ctype_i == 4:  # gray + alpha: take gray
        arr = arr[..., 0]
    else:  # RGB(A) -> luminance
        arr = (arr[..., :3] * np.asarray([0.2126, 0.7152, 0.0722],
                                         np.float32)).sum(axis=-1)
    return np.ascontiguousarray(arr, dtype=np.float32)


# ---------------------------------------------------------------------------
# VTK legacy structured points (formatVTK.c equivalent)
# ---------------------------------------------------------------------------

_VTK_TYPES = {
    "unsigned_char": np.uint8, "char": np.int8,
    "unsigned_short": np.uint16, "short": np.int16,
    "unsigned_int": np.uint32, "int": np.int32,
    "unsigned_long": np.uint64, "long": np.int64,
    "float": np.float32, "double": np.float64,
}


def _lines(data: bytes, start: int = 0):
    """``(line, offset of the next line)`` over ``data`` from ``start``,
    split at ``\\n``; read only as far as the caller iterates."""
    pos = start
    while pos < len(data):
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end
        yield data[pos:end], end + 1
        pos = end + 1


def read_vtk(path: str) -> Volume:
    """Legacy-VTK STRUCTURED_POINTS scalars -> Volume.

    Supports BINARY (big-endian per the VTK legacy spec) and ASCII data,
    the scalar types NrrdIO's ``formatVTK.c`` maps, and 1-component
    SCALARS point data.  Axis order: VTK x fastest -> ``data[z, y, x]``.
    The header ends at the SCALARS line, or at the LOOKUP_TABLE line right
    after it; the data section follows and is never read as header.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"# vtk DataFile Version"):
        raise ValueError(f"{path}: not a legacy VTK file")
    dims = None
    binary = None
    npoints = None
    scal_type = None
    ncomp = 1
    data_start = None  # byte offset of the first data byte
    lines = _lines(data)
    for line, nxt in lines:
        s = line.decode("latin-1").strip()
        u = s.upper()
        if u in ("BINARY", "ASCII"):
            binary = u == "BINARY"
        elif u.startswith("DATASET"):
            if "STRUCTURED_POINTS" not in u:
                raise ValueError(f"{path}: VTK dataset is not "
                                 f"STRUCTURED_POINTS ({s})")
        elif u.startswith("DIMENSIONS"):
            dims = tuple(int(v) for v in s.split()[1:4])
        elif u.startswith("POINT_DATA"):
            npoints = int(s.split()[1])
        elif u.startswith("SCALARS"):
            parts = s.split()
            if len(parts) < 3:
                raise ValueError(f"{path}: malformed SCALARS line {s!r}")
            scal_type = parts[2].lower()
            if len(parts) > 3:
                ncomp = int(parts[3])
            # LOOKUP_TABLE is optional; without it, data follows directly
            data_start = nxt
            following = next(lines, None)
            if following is not None and following[0].decode(
                    "latin-1").strip().upper().startswith("LOOKUP_TABLE"):
                data_start = following[1]
            break
    if dims is None or binary is None or scal_type is None:
        raise ValueError(f"{path}: incomplete VTK structured-points header")
    nx, ny, nz = dims
    if npoints is not None and npoints != nx * ny * nz:
        raise ValueError(f"{path}: POINT_DATA {npoints} != "
                         f"DIMENSIONS product {nx * ny * nz}")
    dt = _VTK_TYPES.get(scal_type)
    if dt is None:
        raise ValueError(f"{path}: unsupported VTK scalar type {scal_type!r}")
    count = nx * ny * nz * ncomp
    if binary:
        # legacy VTK binary data is big-endian
        bdt = np.dtype(dt).newbyteorder(">")
        need = count * bdt.itemsize
        body = data[data_start:data_start + need]
        if len(body) < need:
            raise ValueError(f"{path}: VTK data truncated "
                             f"({len(body)} of {need} bytes)")
        arr = np.frombuffer(body, bdt, count=count).astype(np.float32)
    else:
        text = data[data_start:].decode("latin-1")
        vals = re.findall(r"[-+0-9.eE]+", text)
        if len(vals) < count:
            raise ValueError(f"{path}: VTK ascii data truncated "
                             f"({len(vals)} of {count} values)")
        arr = np.asarray([float(v) for v in vals[:count]], np.float32)
    if ncomp > 1:
        arr = arr.reshape(-1, ncomp)[:, 0]  # first component
    return Volume.from_array(arr.reshape(nz, ny, nx))


# ---------------------------------------------------------------------------
# image stack -> Volume (PNM/PNG files as Z-slices, like the CSV stack)
# ---------------------------------------------------------------------------

def read_image_stack(paths: Sequence[str], reader) -> Volume:
    slices: List[np.ndarray] = []
    shape: Tuple[int, int] | None = None
    for p in paths:
        img = reader(p)
        if shape is None:
            shape = img.shape
        elif img.shape != shape:
            raise ValueError(
                f"{p}: slice shape {img.shape} != first slice {shape} "
                "(all slices must agree, csv_file_parser.cpp:31-40)")
        slices.append(img)
    if not slices:
        raise ValueError("empty image stack")
    return Volume.from_array(np.stack(slices, axis=0))


def read_pnm(paths) -> Volume:
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    return read_image_stack(list(paths), read_pnm_image)


def read_png(paths) -> Volume:
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    return read_image_stack(list(paths), read_png_image)
