"""Host I/O and sRGB conversion tests (native libav backend + PIL fallback)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from reforge_tpu.io import (
    ImageFileDecoder,
    encode,
    native_backend_available,
)
from reforge_tpu.io import imagefile, srgb


def make_rgba(h=40, w=56, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)


class TestSrgb:
    def test_round_trip_u8_exact(self):
        """u8 -> linear f32 -> u8 must be lossless for all 256 code values."""
        codes = np.arange(256, dtype=np.uint8)
        rgba = np.zeros((1, 256, 4), np.uint8)
        rgba[0, :, 0] = codes
        rgba[0, :, 3] = 255
        planar = srgb.decode_image_to_planar(jnp.asarray(rgba))
        back = np.asarray(srgb.encode_planar_to_image(planar))
        np.testing.assert_array_equal(back[0, :, 0], codes)

    def test_curves_match_numpy(self):
        x = np.linspace(0, 1, 1001, dtype=np.float32)
        np.testing.assert_allclose(
            np.asarray(srgb.srgb_to_linear(jnp.asarray(x))),
            srgb.np_srgb_to_linear(x),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(srgb.linear_to_srgb(jnp.asarray(x))),
            srgb.np_linear_to_srgb(x),
            atol=1e-6,
        )

    def test_known_values(self):
        # sRGB 0.5 -> linear ~0.2140
        lin = float(srgb.srgb_to_linear(jnp.float32(0.5)))
        assert abs(lin - 0.21404) < 1e-4


class TestImageFile:
    def test_png_round_trip(self, tmp_path):
        rgba = make_rgba()
        path = str(tmp_path / "x.png")
        encode(path, rgba)
        dec = ImageFileDecoder(path)
        assert (dec.width, dec.height) == (56, 40)
        out = dec.decode(56, 40)
        np.testing.assert_array_equal(out, rgba)

    def test_resize(self, tmp_path):
        rgba = make_rgba(64, 64)
        path = str(tmp_path / "x.png")
        encode(path, rgba)
        out = ImageFileDecoder(path).decode(32, 32)
        assert out.shape == (32, 32, 4)

    def test_jpeg_encode_decode(self, tmp_path):
        # Smooth gradients (not noise): JPEG's 4:2:0 chroma subsampling
        # makes the roundtrip error on random noise encoder-dependent and
        # huge; on smooth content it must be small.
        yy, xx = np.mgrid[0:48, 0:48].astype(np.float32)
        rgba = np.stack(
            [yy * 5, xx * 5, (yy + xx) * 2.5, np.full_like(yy, 255)], axis=-1
        ).clip(0, 255).astype(np.uint8)
        path = str(tmp_path / "x.jpg")
        encode(path, rgba)
        out = ImageFileDecoder(path).decode(48, 48)
        assert out.shape == (48, 48, 4)
        # Lossy but in the ballpark.
        assert np.abs(out[..., :3].astype(int) - rgba[..., :3].astype(int)).mean() < 8

    def test_missing_file_raises(self):
        with pytest.raises(imagefile.ImageFileError):
            ImageFileDecoder("/nonexistent/nope.png")

    def test_native_backend_builds(self):
        # The native .so should be present in this repo's CI environment
        # (make -C native); if not, the PIL fallback silently covers, but we
        # want to know.
        if not native_backend_available():
            pytest.skip("native backend not built")

    def test_pil_fallback_round_trip(self, tmp_path, monkeypatch):
        monkeypatch.setattr(imagefile, "_lib", None)
        monkeypatch.setattr(imagefile, "_lib_tried", True)
        rgba = make_rgba()
        path = str(tmp_path / "y.png")
        encode(path, rgba)
        dec = ImageFileDecoder(path)
        out = dec.decode(56, 40)
        np.testing.assert_array_equal(out, rgba)


def _png_bytes(px: np.ndarray, ctype: int, filt: int) -> bytes:
    """A straightforward PNG encoder for one filter type (the reference the
    numpy codec's unfilter is checked against)."""
    import struct
    import zlib

    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        line = rows[y]
        out = np.zeros_like(line)
        for x in range(w * ch):
            a = line[x - ch] if x >= ch else 0
            b = prior[x]
            c = prior[x - ch] if x >= ch else 0
            if filt == 0:
                pred = 0
            elif filt == 1:
                pred = a
            elif filt == 2:
                pred = b
            elif filt == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[x] = (line[x] - pred) % 256
        raw += bytes([filt]) + bytes(out.astype(np.uint8))
        prior = line

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(bytes(raw)))
        + chunk(b"IEND", b"")
    )


@pytest.fixture
def no_image_libs(monkeypatch):
    """Neither the native extension nor PIL: the numpy + zlib PNG codec."""
    import sys

    monkeypatch.setattr(imagefile, "_lib", None)
    monkeypatch.setattr(imagefile, "_lib_tried", True)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert imagefile._pil_image() is None


class TestNumpyPng:
    """The PNG codec that needs only numpy and zlib."""

    @pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
    @pytest.mark.parametrize("ctype, ch", [(0, 1), (2, 3), (6, 4)])
    def test_reads_every_filter_and_color_type(self, tmp_path, ctype, ch, filt):
        px = make_rgba(h=9, w=11, seed=ctype * 10 + filt)[..., :ch]
        path = tmp_path / "f.png"
        path.write_bytes(_png_bytes(px, ctype, filt))
        got = imagefile.png_read(str(path))
        want = {1: np.repeat(px, 3, axis=2), 3: px, 4: px}[ch]
        np.testing.assert_array_equal(got[..., :3], want[..., :3])
        alpha = px[..., 3] if ch == 4 else np.full((9, 11), 255, np.uint8)
        np.testing.assert_array_equal(got[..., 3], alpha)
        assert imagefile.png_size(str(path)) == (9, 11)

    def test_write_read_round_trip(self, tmp_path):
        rgba = make_rgba(h=33, w=47, seed=4)
        path = str(tmp_path / "w.png")
        imagefile.png_write(path, rgba)
        np.testing.assert_array_equal(imagefile.png_read(path), rgba)

    def test_written_png_reads_in_pil(self, tmp_path):
        Image = pytest.importorskip("PIL.Image")
        rgba = make_rgba(h=21, w=30, seed=5)
        path = str(tmp_path / "p.png")
        imagefile.png_write(path, rgba)
        with Image.open(path) as im:
            assert im.mode == "RGBA"
            np.testing.assert_array_equal(np.asarray(im), rgba)

    def test_decoder_and_encoder_fall_back_to_it(self, tmp_path, no_image_libs):
        rgba = make_rgba()
        path = str(tmp_path / "z.png")
        encode(path, rgba)
        dec = ImageFileDecoder(path)
        assert (dec.width, dec.height) == (56, 40)
        np.testing.assert_array_equal(dec.decode(56, 40), rgba)

    def test_without_libs_jpeg_and_resize_raise(self, tmp_path, no_image_libs):
        rgba = make_rgba()
        with pytest.raises(imagefile.ImageFileError, match="PNG works"):
            encode(str(tmp_path / "z.jpg"), rgba)
        path = str(tmp_path / "z.png")
        encode(path, rgba)
        with pytest.raises(imagefile.ImageFileError, match="resizing"):
            ImageFileDecoder(path).decode(28, 20)

    def test_rejects_what_it_cannot_read(self, tmp_path):
        bad = tmp_path / "bad.png"
        bad.write_bytes(b"not a png at all")
        with pytest.raises(imagefile.ImageFileError, match="not a PNG"):
            imagefile.png_read(str(bad))
        pal = tmp_path / "pal.png"
        pal.write_bytes(_png_bytes(make_rgba(4, 4)[..., :1], 0, 0)
                        .replace(b"IHDR\x00\x00\x00\x04\x00\x00\x00\x04\x08\x00",
                                 b"IHDR\x00\x00\x00\x04\x00\x00\x00\x04\x08\x03"))
        with pytest.raises(imagefile.ImageFileError, match="8-bit"):
            imagefile.png_read(str(pal))


class TestVideo:
    def test_video_round_trip(self, tmp_path):
        if not native_backend_available():
            pytest.skip("native backend not built")
        from reforge_tpu.io import VideoEncoder, VideoFrames, is_video_path

        assert is_video_path("x.mp4") and not is_video_path("x.png")
        path = str(tmp_path / "v.mp4")
        with VideoEncoder(path, 64, 48, fps=25) as enc:
            for i in range(10):
                f = np.zeros((48, 64, 4), np.uint8)
                f[:, :, 0] = i * 20
                f[:, :, 3] = 255
                enc.write(f)
        dec = ImageFileDecoder(path)
        frames = list(VideoFrames(dec, 64, 48))
        assert len(frames) == 10
        # Lossy, but the red ramp must be monotone.
        reds = [f[:, :, 0].mean() for f in frames]
        assert reds[0] < reds[4] < reds[9]

    def test_video_cli_end_to_end(self, tmp_path):
        if not native_backend_available():
            pytest.skip("native backend not built")
        from reforge_tpu.cli import main
        from reforge_tpu.io import VideoEncoder, VideoFrames

        inp = str(tmp_path / "in.mp4")
        outp = str(tmp_path / "out.mp4")
        with VideoEncoder(inp, 64, 48, fps=25) as enc:
            for i in range(8):
                f = np.full((48, 64, 4), 30, np.uint8)
                f[:, :, 3] = 255
                enc.write(f)
        cfg = tmp_path / "g.rf"
        cfg.write_text("input -> invert -> output")
        rc = main(["-i", inp, "-o", outp, "--config", str(cfg),
                   "--shader-path", str(tmp_path)])
        assert rc == 0
        frames = list(VideoFrames(ImageFileDecoder(outp), 64, 48))
        assert len(frames) == 8
        assert frames[0][:, :, 0].mean() > 180  # dark input inverted bright

    def test_video_batch_frames_identical(self, tmp_path):
        # --batch-frames K runs K frames per dispatch; output must be
        # frame-exact vs the single-frame pipeline, including the padded
        # tail batch (8 frames at K=3 leaves a 2-frame remainder).
        if not native_backend_available():
            pytest.skip("native backend not built")
        from reforge_tpu.cli import main
        from reforge_tpu.io import VideoEncoder, VideoFrames

        inp = str(tmp_path / "in.mp4")
        with VideoEncoder(inp, 64, 48, fps=25) as enc:
            rng = np.random.default_rng(9)
            for i in range(8):
                f = rng.integers(0, 255, (48, 64, 4), np.uint8)
                f[:, :, 3] = 255
                enc.write(f)
        cfg = tmp_path / "g.rf"
        cfg.write_text("input -> invert -> output")
        o1 = str(tmp_path / "k1.mp4")
        o3 = str(tmp_path / "k3.mp4")
        assert main(["-i", inp, "-o", o1, "--config", str(cfg),
                     "--shader-path", str(tmp_path)]) == 0
        assert main(["-i", inp, "-o", o3, "--config", str(cfg),
                     "--shader-path", str(tmp_path), "--batch-frames", "3"]) == 0
        f1 = list(VideoFrames(ImageFileDecoder(o1), 64, 48))
        f3 = list(VideoFrames(ImageFileDecoder(o3), 64, 48))
        assert len(f1) == len(f3) == 8
        for a, b in zip(f1, f3):
            np.testing.assert_array_equal(a, b)

    def test_video_start_duration_trim(self, tmp_path):
        # --start/--duration: keyframe seek + pts-exact trim.
        if not native_backend_available():
            pytest.skip("native backend not built")
        from reforge_tpu.io import VideoEncoder, VideoFrames

        inp = str(tmp_path / "in.mp4")
        with VideoEncoder(inp, 64, 48, fps=10) as enc:
            for i in range(20):
                f = np.zeros((48, 64, 4), np.uint8)
                f[:, : 3 * (i + 1), 0] = 255  # frame index encoded in bar width
                f[:, :, 3] = 255
                enc.write(f)
        # Library surface: frames [1.0s, 1.5s) at 10 fps = indices 10..14.
        dec = ImageFileDecoder(inp)
        got = list(VideoFrames(dec, 64, 48, start=1.0, duration=0.5))
        assert len(got) == 5
        widths = [int((f[:, :, 0].astype(int).mean(axis=0) > 128).sum())
                  for f in got]
        assert widths == [3 * (i + 1) for i in range(10, 15)], widths
