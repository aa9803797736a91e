from volumetric_renderer_torch.render.api import (
    adjust_display,
    composite_over,
    render,
)

__all__ = ["render", "composite_over", "adjust_display"]
