"""Format dispatch for volume import.

Equivalent of the reference's ``Importer`` (``src/data/importer.{h,cpp}``)
minus the native file dialogs: format is chosen by extension or explicitly,
parse errors raise ``VolumeImportError`` (the reference surfaces them in a
modal error popup, ``importer.cpp:47-49``).

NRRD and CSV stacks are supported.  The VTK, PNM and PNG readers of the JAX
package (``volumetric_renderer_tpu/data/formats.py``) are not ported yet:
those formats are still recognised by extension and raise
``VolumeImportError``.
"""

from __future__ import annotations

import os
from typing import Sequence

from volumetric_renderer_torch.data.volume import Volume


class VolumeImportError(RuntimeError):
    """Raised when a dataset cannot be parsed (UI error-popup equivalent)."""


_NOT_PORTED = ("vtk", "pnm", "png")


def import_volume(path_or_paths, fmt: str | None = None) -> Volume:
    """Import a volume: NRRD (single file) or CSV slice stack (list).

    ``fmt``: ``"nrrd"`` | ``"csv"`` | None (infer from extension, mirroring
    the enum dispatch in ``importer.cpp:20-40``).  ``"vtk"``, ``"pnm"`` and
    ``"png"`` are recognised but raise ``VolumeImportError``.
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

    if fmt in _NOT_PORTED:
        raise VolumeImportError(f"{fmt} import is not yet ported")
    try:
        if fmt == "nrrd":
            if single is None and len(paths) != 1:
                raise VolumeImportError("NRRD import takes a single file")
            from volumetric_renderer_torch.data.nrrd import read_nrrd

            return read_nrrd(paths[0])
        if fmt == "csv":
            from volumetric_renderer_torch.data.csv_stack import read_csv_stack

            return read_csv_stack(paths)
    except VolumeImportError:
        raise
    except Exception as e:  # parser failure -> import error (importer.cpp:47-49)
        raise VolumeImportError(str(e)) from e
    raise VolumeImportError(f"unknown format {fmt!r}")
