from volumetric_renderer_torch.data.volume import Volume
from volumetric_renderer_torch.data.importer import import_volume

__all__ = ["Volume", "import_volume"]
