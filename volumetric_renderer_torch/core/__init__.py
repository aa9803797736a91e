from volumetric_renderer_torch.core.sampling import trilinear_sample
from volumetric_renderer_torch.core.marcher import march_rays, render_oracle

__all__ = ["trilinear_sample", "march_rays", "render_oracle"]
