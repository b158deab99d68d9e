"""Host image I/O and color management.

JAX replacement for the reference's ffmpeg FFI layer
(reference: src/imagefileio.rs) plus the sRGB load/store conversions the
reference performs with Vulkan sRGB-image blits (src/render.rs:264-312).
"""

from .imagefile import (
    ImageFileDecoder,
    ImageFileError,
    VideoEncoder,
    VideoFrames,
    encode,
    is_video_path,
    native_backend_available,
)
from .srgb import (
    decode_image_to_planar,
    encode_planar_to_image,
    linear_to_srgb,
    srgb_to_linear,
)

__all__ = [
    "ImageFileDecoder",
    "ImageFileError",
    "VideoEncoder",
    "VideoFrames",
    "encode",
    "is_video_path",
    "native_backend_available",
    "decode_image_to_planar",
    "encode_planar_to_image",
    "linear_to_srgb",
    "srgb_to_linear",
]
