from volumetric_renderer_torch.utils.config import RenderSettings
from volumetric_renderer_torch.utils import quaternion
from volumetric_renderer_torch.utils import color

__all__ = ["RenderSettings", "quaternion", "color"]
