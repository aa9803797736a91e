from volumetric_renderer_torch.transfer.gradient import Gradient
from volumetric_renderer_torch.transfer.texture import sample_tf

__all__ = ["Gradient", "sample_tf"]
