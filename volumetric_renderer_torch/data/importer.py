"""Format dispatch for volume import.

Equivalent of the reference's ``Importer`` (``src/data/importer.{h,cpp}``)
minus the native file dialogs: format is chosen by extension or explicitly,
parse errors raise ``VolumeImportError`` (the reference surfaces them in a
modal error popup, ``importer.cpp:47-49``).
"""

from __future__ import annotations

import os
from typing import Sequence

from volumetric_renderer_torch.data.volume import Volume


class VolumeImportError(RuntimeError):
    """Raised when a dataset cannot be parsed (UI error-popup equivalent)."""


def import_volume(path_or_paths, fmt: str | None = None) -> Volume:
    """Import a volume: NRRD (single file), CSV slice stack (list), VTK
    structured points (single file), or PNM/PNG image slice stacks.

    ``fmt``: ``"nrrd"`` | ``"csv"`` | ``"vtk"`` | ``"pnm"`` | ``"png"`` |
    None (infer from extension, mirroring the enum dispatch in
    ``importer.cpp:20-40``; the non-NRRD image formats are NrrdIO
    capabilities — ``extern/NrrdIO/formatPNM.c``, ``formatPNG.c``,
    ``formatVTK.c`` — unused by the reference app).
    """
    if isinstance(path_or_paths, (list, tuple)):
        paths: Sequence[str] = [os.fspath(p) for p in path_or_paths]
        single = None
    else:
        single = os.fspath(path_or_paths)
        paths = [single]

    if fmt is None:
        ext = os.path.splitext(paths[0])[1].lower()
        if ext in (".nrrd", ".nhdr"):
            fmt = "nrrd"
        elif ext == ".csv":
            fmt = "csv"
        elif ext == ".vtk":
            fmt = "vtk"
        elif ext in (".pgm", ".ppm", ".pbm", ".pnm"):
            fmt = "pnm"
        elif ext == ".png":
            fmt = "png"
        else:
            raise VolumeImportError(f"cannot infer format from {paths[0]!r}")

    try:
        if fmt == "nrrd":
            if single is None and len(paths) != 1:
                raise VolumeImportError("NRRD import takes a single file")
            from volumetric_renderer_torch.data.nrrd import read_nrrd

            return read_nrrd(paths[0])
        if fmt == "csv":
            from volumetric_renderer_torch.data.csv_stack import read_csv_stack

            return read_csv_stack(paths)
        if fmt == "vtk":
            if single is None and len(paths) != 1:
                raise VolumeImportError("VTK import takes a single file")
            from volumetric_renderer_torch.data.formats import read_vtk

            return read_vtk(paths[0])
        if fmt == "pnm":
            from volumetric_renderer_torch.data.formats import read_pnm

            return read_pnm(paths)
        if fmt == "png":
            from volumetric_renderer_torch.data.formats import read_png

            return read_png(paths)
    except VolumeImportError:
        raise
    except Exception as e:  # parser failure -> import error (importer.cpp:47-49)
        raise VolumeImportError(str(e)) from e
    raise VolumeImportError(f"unknown format {fmt!r}")
