"""Color-space helpers.

The reference's transfer-function texture is ``R8G8B8A8_SRGB``
(``src/rendering/offscreen_pass.cpp:1076``): the sampler linearizes RGB (not
alpha) on fetch, while the offscreen color target is UNORM.  This framework
keeps everything in linear float throughout; these helpers exist to emulate
the reference's 8-bit sRGB quantization when byte-level parity is wanted.
The sRGB curves work on tensors; the RGBA8 packers stay NumPy.
"""

from __future__ import annotations

import numpy as np
import torch


def srgb_to_linear(c):
    c = torch.as_tensor(c)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = torch.as_tensor(c)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)


def linearize_tf_table(tf_table):
    """sRGB-decode a transfer-function table's RGB channels (alpha is
    passed through).

    Reproduces the reference's ``R8G8B8A8_SRGB`` TF texture
    (``src/rendering/offscreen_pass.cpp:1076``): the Vulkan sampler
    converts each texel sRGB -> linear *before* the linear filter, which
    is exactly equivalent to pre-decoding the whole table and then doing
    the standard lerp lookup.  Alpha in sRGB images is always stored
    linearly, so only RGB is decoded.
    """
    tf_table = torch.as_tensor(tf_table, dtype=torch.float32)
    return torch.cat([srgb_to_linear(tf_table[..., :3]), tf_table[..., 3:]],
                     dim=-1)


def pack_rgba8(rgba: np.ndarray) -> np.ndarray:
    """Pack float RGBA in [0,1] to u32 (ABGR byte order, IM_COL32-style).

    Mirrors ``ImGui::ColorConvertFloat4ToU32`` used by
    ``Gradient::discretize`` (``src/ui/components/gradient.cpp:90-108``):
    R in the low byte.
    """
    rgba = np.clip(np.asarray(rgba, dtype=np.float64), 0.0, 1.0)
    b = np.round(rgba * 255.0).astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def unpack_rgba8(packed: np.ndarray) -> np.ndarray:
    packed = np.asarray(packed, dtype=np.uint32)
    out = np.stack(
        [
            packed & 0xFF,
            (packed >> 8) & 0xFF,
            (packed >> 16) & 0xFF,
            (packed >> 24) & 0xFF,
        ],
        axis=-1,
    )
    return out.astype(np.float32) / 255.0
