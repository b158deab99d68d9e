"""Host image decode/encode.

Primary backend: the native C++ libav extension (native/imageio.cpp, built
to libreforge_io.so and loaded via ctypes) — the analog of the reference's
raw ffmpeg FFI (reference: src/imagefileio.rs): decode any libav-supported
image or video's first frame with Lanczos resize straight into an RGBA8
buffer, and PNG-encode at max compression.  Falls back to PIL when the .so
is absent (e.g. no toolchain), keeping behavior identical.  With neither,
8-bit PNGs (gray, RGB, RGBA; no interlace) still decode and encode through
a small numpy + zlib codec below, at the image's own size; JPEG, resizing
and video then raise ImageFileError.

All APIs traffic in numpy uint8 arrays of shape (H, W, 4), sRGB-encoded;
linearization happens on device (io/srgb.py).
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Optional

import numpy as np

from ..utils import warnln

_NATIVE_PATH = os.path.join(os.path.dirname(__file__), "libreforge_io.so")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _native_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_NATIVE_PATH):
        return None
    try:
        lib = ctypes.CDLL(_NATIVE_PATH)
    except OSError as e:
        warnln(f"Failed to load native imageio ({e}); falling back to PIL")
        return None
    lib.rf_decoder_open.restype = ctypes.c_void_p
    lib.rf_decoder_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.rf_decoder_dims.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.rf_decoder_decode.restype = ctypes.c_int
    lib.rf_decoder_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rf_decoder_close.argtypes = [ctypes.c_void_p]
    lib.rf_decoder_next.restype = ctypes.c_int
    lib.rf_decoder_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rf_decoder_fps.restype = ctypes.c_double
    lib.rf_decoder_fps.argtypes = [ctypes.c_void_p]
    lib.rf_decoder_seek.restype = ctypes.c_int
    lib.rf_decoder_seek.argtypes = [
        ctypes.c_void_p,
        ctypes.c_double,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rf_decoder_next2.restype = ctypes.c_int
    lib.rf_decoder_next2.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rf_venc_open.restype = ctypes.c_void_p
    lib.rf_venc_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rf_venc_write.restype = ctypes.c_int
    lib.rf_venc_write.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.rf_venc_close.restype = ctypes.c_int
    lib.rf_venc_close.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rf_encode.restype = ctypes.c_int
    lib.rf_encode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    _lib = lib
    return _lib


class ImageFileError(Exception):
    pass


class ImageFileDecoder:
    """Decode a file's first frame to RGBA8 at a requested size.

    Mirrors the reference ImageFileDecoder (imagefileio.rs:84-184): probe
    on construction (exposing source width/height for aspect-fit dimension
    selection), then decode+Lanczos-resize into an RGBA8 buffer.
    """

    def __init__(self, path: str):
        self.path = path
        self._native = None
        self.width = 0
        self.height = 0
        lib = _native_lib()
        if lib is not None:
            err = ctypes.create_string_buffer(512)
            handle = lib.rf_decoder_open(path.encode(), err, len(err))
            if not handle:
                raise ImageFileError(err.value.decode() or f"Failed to open {path}")
            self._native = ctypes.c_void_p(handle)
            w = ctypes.c_int()
            h = ctypes.c_int()
            lib.rf_decoder_dims(self._native, ctypes.byref(w), ctypes.byref(h))
            self.width, self.height = w.value, h.value
        elif _pil_image() is not None:
            try:
                with _pil_image().open(path) as im:
                    self.width, self.height = im.size
            except Exception as e:
                raise ImageFileError(f"Failed to open '{path}': {e}") from e
        else:
            self.height, self.width = png_size(path)

    def decode(self, width: int, height: int) -> np.ndarray:
        """Return (height, width, 4) uint8 RGBA, Lanczos-resized."""
        lib = _native_lib()
        if self._native is not None and lib is not None:
            out = np.empty((height, width, 4), dtype=np.uint8)
            err = ctypes.create_string_buffer(512)
            rc = lib.rf_decoder_decode(
                self._native,
                out.ctypes.data_as(ctypes.c_char_p),
                width,
                height,
                err,
                len(err),
            )
            if rc != 0:
                raise ImageFileError(err.value.decode() or "decode failed")
            return out
        Image = _pil_image()
        if Image is None:
            rgba = png_read(self.path)
            if rgba.shape[:2] != (height, width):
                raise ImageFileError(
                    f"resizing {self.path} to {width}x{height} needs the "
                    "native io backend (make -C native) or PIL"
                )
            return rgba
        with Image.open(self.path) as im:
            im = im.convert("RGBA")
            if (width, height) != im.size:
                im = im.resize((width, height), Image.LANCZOS)
            return np.asarray(im, dtype=np.uint8).copy()

    def close(self) -> None:
        lib = _native_lib()
        if self._native is not None and lib is not None:
            lib.rf_decoder_close(self._native)
            self._native = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".webm", ".mov", ".m4v", ".mpg")


def is_video_path(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS


class VideoFrames:
    """Sequential frame iterator over a video (native backend only).

    Goes beyond the reference, which decodes only a video's first frame
    (imagefileio.rs:129-152).
    """

    def __init__(self, decoder: ImageFileDecoder, width: int, height: int,
                 start: float = 0.0, duration: float | None = None):
        if decoder._native is None or _native_lib() is None:
            raise ImageFileError(
                "Video streaming requires the native io backend (make -C native)"
            )
        self._dec = decoder
        self.width = width
        self.height = height
        self.start = max(0.0, float(start))
        self.duration = duration

    @property
    def fps(self) -> float:
        lib = _native_lib()
        fps = lib.rf_decoder_fps(self._dec._native)
        return fps if fps > 0 else 30.0

    def __iter__(self):
        lib = _native_lib()
        err = ctypes.create_string_buffer(512)
        end = None if self.duration is None else self.start + float(self.duration)
        if self.start > 0.0:
            # Keyframe seek, then decode-and-discard up to the exact start.
            if lib.rf_decoder_seek(
                self._dec._native, self.start, err, len(err)
            ) != 0:
                raise ImageFileError(err.value.decode() or "seek failed")
        pts = ctypes.c_double(-1.0)
        eps = 1e-6
        while True:
            out = np.empty((self.height, self.width, 4), dtype=np.uint8)
            rc = lib.rf_decoder_next2(
                self._dec._native,
                out.ctypes.data_as(ctypes.c_char_p),
                self.width,
                self.height,
                ctypes.byref(pts),
                err,
                len(err),
            )
            if rc == 1:
                return
            if rc != 0:
                raise ImageFileError(err.value.decode() or "video decode failed")
            t = pts.value
            if t >= 0.0:
                if t < self.start - eps:
                    continue  # pre-roll frames from the keyframe seek
                if end is not None and t >= end - eps:
                    return
            yield out


class VideoEncoder:
    """Encode RGBA8 frames to a video container (codec from extension)."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        lib = _native_lib()
        if lib is None:
            raise ImageFileError(
                "Video encoding requires the native io backend (make -C native)"
            )
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        handle = lib.rf_venc_open(
            path.encode(), width, height, float(fps), err, len(err)
        )
        if not handle:
            raise ImageFileError(err.value.decode() or f"cannot open {path}")
        self._enc = ctypes.c_void_p(handle)
        self.width = width
        self.height = height
        self.frames_written = 0

    def write(self, rgba: np.ndarray) -> None:
        rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
        expected = (self.height, self.width, 4)
        if rgba.shape != expected:
            # The C side assumes stride width*4; a mismatched array would
            # make sws_scale read out of bounds.
            raise ImageFileError(
                f"encoder expects frames of shape {expected}, got {rgba.shape}"
            )
        err = ctypes.create_string_buffer(512)
        rc = self._lib.rf_venc_write(
            self._enc, rgba.ctypes.data_as(ctypes.c_char_p), err, len(err)
        )
        if rc != 0:
            raise ImageFileError(err.value.decode() or "video encode failed")
        self.frames_written += 1

    def close(self) -> None:
        if self._enc is not None:
            err = ctypes.create_string_buffer(512)
            rc = self._lib.rf_venc_close(self._enc, err, len(err))
            self._enc = None
            if rc != 0:
                # A failed flush/trailer write leaves a corrupt file; the
                # caller must not report success.
                raise ImageFileError(
                    err.value.decode() or "video finalize failed"
                )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # Don't mask the original exception with a finalize error.
            try:
                self.close()
            except ImageFileError:
                pass
            return False
        self.close()
        return False


def encode(path: str, rgba: np.ndarray) -> None:
    """Write (H, W, 4) uint8 RGBA to an image file (codec by extension).

    PNG output uses max compression for parity with the reference encoder
    (imagefileio.rs:237-241).
    """
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    ext = os.path.splitext(path)[1].lower()
    lib = _native_lib()
    # The native encoder implements PNG and JPEG; other extensions (.bmp,
    # .webp, .tif, ...) go through PIL so the bytes match the extension.
    if ext not in (".png", ".jpg", ".jpeg", ""):
        lib = None
    if lib is not None:
        err = ctypes.create_string_buffer(512)
        rc = lib.rf_encode(
            path.encode(), rgba.ctypes.data_as(ctypes.c_char_p), w, h, err, len(err)
        )
        if rc != 0:
            raise ImageFileError(err.value.decode() or "encode failed")
        return
    Image = _pil_image()
    if Image is None:
        if ext != ".png":
            raise ImageFileError(
                f"writing {ext or 'extension-less'} files needs the native io "
                "backend (make -C native) or PIL; PNG works without either"
            )
        png_write(path, rgba)
        return
    im = Image.fromarray(rgba, "RGBA")
    if ext in (".jpg", ".jpeg"):
        im = im.convert("RGB")
        im.save(path, quality=95)
    else:
        im.save(path, compress_level=9)


def native_backend_available() -> bool:
    return _native_lib() is not None


def _pil_image():
    """PIL's Image module, or None when PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


# ---- numpy + zlib PNG codec ------------------------------------------------
#
# The fallback when neither the native extension nor PIL is importable:
# 8-bit gray (color type 0), RGB (2) and RGBA (6), no interlace, any of the
# five row filters on read; RGBA with the Up filter on write.

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def _png_chunks(data: bytes, path: str):
    if data[:8] != _PNG_SIG:
        raise ImageFileError(f"'{path}' is not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ImageFileError(f"'{path}': truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ImageFileError(f"'{path}': PNG has no IEND chunk")


def _png_header(body: bytes, path: str) -> tuple[int, int, int]:
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ImageFileError(
            f"'{path}': only 8-bit gray/RGB/RGBA non-interlaced PNGs can be "
            "read without the native io backend or PIL"
        )
    return h, w, _PNG_CHANNELS[ctype]


def png_size(path: str) -> tuple[int, int]:
    """(height, width) of a PNG file."""
    try:
        with open(path, "rb") as f:
            head = f.read(33)
    except OSError as e:
        raise ImageFileError(f"Failed to open '{path}': {e}") from e
    kind, body = next(_png_chunks(head, path))
    if kind != b"IHDR":
        raise ImageFileError(f"'{path}': PNG does not start with IHDR")
    h, w, _ = _png_header(body, path)
    return h, w


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        line, kind = data[y], kinds[y]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:  # Up
            cur = (line + prior) & 255
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prior[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ImageFileError(f"'{path}': bad PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def png_read(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, 4) uint8 RGBA (gray and RGB gain opaque alpha)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ImageFileError(f"Failed to open '{path}': {e}") from e
    header = None
    idat = []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = _png_header(body, path)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ImageFileError(f"'{path}': PNG has no IHDR chunk")
    h, w, ch = header
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ImageFileError(f"'{path}': corrupt PNG data: {e}") from e
    if raw.size != h * (w * ch + 1):
        raise ImageFileError(f"'{path}': PNG data size does not match IHDR")
    px = _unfilter(raw, h, w * ch, ch, path).reshape(h, w, ch)
    if ch == 4:
        return px
    rgb = np.repeat(px, 3, axis=2) if ch == 1 else px
    alpha = np.full((h, w, 1), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=2)


def png_write(path: str, rgba: np.ndarray, level: int = 6) -> None:
    """Encode (H, W, 4) uint8 RGBA as a PNG (Up filter on every row)."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ImageFileError(f"expected (H, W, 4) uint8 RGBA, got {rgba.shape}")
    h, w = rgba.shape[:2]
    rows = rgba.reshape(h, w * 4)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # uint8 arithmetic wraps mod 256
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    data = (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
        + chunk(b"IEND", b"")
    )
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError as e:
        raise ImageFileError(f"Failed to write '{path}': {e}") from e
