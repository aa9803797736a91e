from volumetric_renderer_torch.scene.camera import OrbitCamera, ray_grid

__all__ = ["OrbitCamera", "ray_grid"]
