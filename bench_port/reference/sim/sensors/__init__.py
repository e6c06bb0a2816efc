from .depth import DepthCameraCfg, depth_image, pinhole_rays

__all__ = ["DepthCameraCfg", "depth_image", "pinhole_rays"]
