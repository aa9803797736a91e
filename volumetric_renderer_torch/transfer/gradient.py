"""Marker-based transfer-function gradient.

Mirrors the reference's ``Gradient`` data model
(``src/ui/components/gradient.{h,cpp}``): separate sorted lists of color
markers ``(location, rgb)`` and alpha markers ``(location, a)``, sampled
piecewise-linearly between neighbors with clamped ends
(``gradient.cpp:471-485``), and discretized to an N-texel RGBA table at texel
centers ``(i + 0.5) / N`` (``gradient.cpp:90-108``).

In this framework the marker model is the *initializer* / editing surface;
the optimizable object handed to the renderer is the dense float table
returned by :meth:`Gradient.discretize` (see ``transfer.texture`` for the
differentiable lookup).  This replaces the ImGui gradient-editor widget
(``gradient.cpp:134-469``) with a plain Python API.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple

import numpy as np

from volumetric_renderer_torch.utils.color import pack_rgba8


class Gradient:
    """Editable piecewise-linear transfer function.

    Defaults match ``gradient.cpp:64-70``: color black -> white, alpha 1 -> 1.
    The first and last markers are locked (cannot be removed, mirroring
    ``gradient.cpp:487-515``); their locations are 0 and 1.
    """

    def __init__(
        self,
        color_markers: Sequence[Tuple[float, Sequence[float]]] | None = None,
        alpha_markers: Sequence[Tuple[float, float]] | None = None,
    ):
        if color_markers is None:
            color_markers = [(0.0, (0.0, 0.0, 0.0)), (1.0, (1.0, 1.0, 1.0))]
        if alpha_markers is None:
            alpha_markers = [(0.0, 1.0), (1.0, 1.0)]
        self.color_markers: List[Tuple[float, np.ndarray]] = [
            (float(loc), np.asarray(v, dtype=np.float32)) for loc, v in color_markers
        ]
        self.alpha_markers: List[Tuple[float, float]] = [
            (float(loc), float(v)) for loc, v in alpha_markers
        ]
        self.color_markers.sort(key=lambda m: m[0])
        self.alpha_markers.sort(key=lambda m: m[0])

    # -- sampling (``gradient.cpp:471-485``) -------------------------------
    @staticmethod
    def _sample_markers(markers, location: float):
        location = min(max(location, 0.0), 1.0)
        locs = [m[0] for m in markers]
        # lower_bound: first marker with loc >= location
        i = bisect.bisect_left(locs, location)
        if i == 0:
            return markers[0][1]
        if i == len(markers):
            return markers[-1][1]
        prev_loc, prev_val = markers[i - 1]
        curr_loc, curr_val = markers[i]
        t = (location - prev_loc) / (curr_loc - prev_loc)
        return prev_val + (np.asarray(curr_val) - prev_val) * t

    def sample_color(self, location: float) -> np.ndarray:
        return np.asarray(self._sample_markers(self.color_markers, location))

    def sample_alpha(self, location: float) -> float:
        return float(self._sample_markers(self.alpha_markers, location))

    def sample(self, location: float) -> np.ndarray:
        return np.concatenate(
            [self.sample_color(location), [self.sample_alpha(location)]]
        ).astype(np.float32)

    # -- discretization (``gradient.cpp:90-108``) --------------------------
    def discretize(self, count: int = 256, quantize_8bit: bool = False) -> np.ndarray:
        """Dense ``(count, 4)`` float32 RGBA table sampled at texel centers.

        ``quantize_8bit=True`` additionally rounds through u8, matching the
        reference's RGBA8 texture upload exactly.
        """
        locs = (np.arange(count, dtype=np.float64) + 0.5) / count
        table = np.stack([self.sample(float(l)) for l in locs]).astype(np.float32)
        if quantize_8bit:
            table = np.round(np.clip(table, 0.0, 1.0) * 255.0) / 255.0
        return table

    def discretize_packed(self, count: int = 256) -> np.ndarray:
        """u32-packed table, byte-identical to ``Gradient::discretize``."""
        return pack_rgba8(self.discretize(count))

    # -- editing (``gradient.cpp:487-541``) --------------------------------
    def add_color_marker(self, location: float, value: Sequence[float]) -> int:
        return self._add(self.color_markers, location, np.asarray(value, np.float32))

    def add_alpha_marker(self, location: float, value: float) -> int:
        return self._add(self.alpha_markers, location, float(value))

    @staticmethod
    def _add(markers, location: float, value) -> int:
        location = min(max(float(location), 0.0), 1.0)
        locs = [m[0] for m in markers]
        i = bisect.bisect_left(locs, location)
        i = max(1, min(i, len(markers) - 1))
        markers.insert(i, (location, value))
        return i

    def remove_color_marker(self, index: int) -> bool:
        return self._remove(self.color_markers, index)

    def remove_alpha_marker(self, index: int) -> bool:
        return self._remove(self.alpha_markers, index)

    @staticmethod
    def _remove(markers, index: int) -> bool:
        if index <= 0 or index >= len(markers) - 1:
            return False  # endpoints are locked
        del markers[index]
        return True

    def move_color_marker(self, index: int, location: float) -> int:
        return self._move(self.color_markers, index, location)

    def move_alpha_marker(self, index: int, location: float) -> int:
        return self._move(self.alpha_markers, index, location)

    @staticmethod
    def _move(markers, index: int, location: float) -> int:
        """Drag a marker to ``location``; returns its index afterwards.

        Mirrors the editor's drag semantics (``gradient.cpp:565-592``):
        endpoints cannot be dragged (``state.dragging`` is only armed for
        interior markers, ``gradient.cpp:568-569`` — a no-op here), the
        location clamps to [0, 1] (``gradient.cpp:656``), and the moved
        marker shuffles through its neighbors to restore sort order while
        staying interior (shuffle-down stops at index 1, shuffle-up at
        ``len-2``, ``gradient.cpp:577-592``) — so a marker dragged past an
        endpoint parks right next to it rather than displacing it.
        """
        if index <= 0 or index >= len(markers) - 1:
            return index  # endpoints are locked
        location = min(max(float(location), 0.0), 1.0)
        moved = (location, markers[index][1])
        markers[index] = moved
        # shuffle down (never below 1)
        while index > 1 and moved[0] < markers[index - 1][0]:
            markers[index] = markers[index - 1]
            index -= 1
        # shuffle up (never above len-2)
        while index < len(markers) - 2 and moved[0] > markers[index + 1][0]:
            markers[index] = markers[index + 1]
            index += 1
        markers[index] = moved
        return index

    def set_color_marker(self, index: int, value: Sequence[float]) -> None:
        """Re-color a marker in place (any marker, endpoints included —
        the editor's color picker applies to the selection regardless of
        position, ``gradient.cpp:347-431``; only drag/delete are locked)."""
        loc = self.color_markers[index][0]
        self.color_markers[index] = (loc, np.asarray(value, np.float32))

    def set_alpha_marker(self, index: int, value: float) -> None:
        """Re-alpha a marker in place (see :meth:`set_color_marker`)."""
        loc = self.alpha_markers[index][0]
        self.alpha_markers[index] = (loc, float(value))

    # -- presets -----------------------------------------------------------
    @classmethod
    def grayscale_ramp(cls) -> "Gradient":
        """Black->white color ramp with alpha 0 -> 1 (BASELINE config 1)."""
        return cls(alpha_markers=[(0.0, 0.0), (1.0, 1.0)])
