"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

``march`` is the forward ray march (K1).  Its CUDA source lives in
``csrc/march_fwd.cu`` and is compiled on first use (``_build``).
"""

from volumetric_renderer_torch.kernels.march import (  # noqa: F401
    march_forward,
    march_forward_plain,
)
