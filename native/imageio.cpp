// Native host image I/O for reforge-tpu.
//
// This program's counterpart of the reference's ffmpeg FFI layer
// (reference: src/imagefileio.rs): decode the first frame of any
// libav-supported image/video, Lanczos-resize + pixel-format-convert it
// straight into a caller-provided RGBA8 buffer (imagefileio.rs:129-184),
// and encode RGBA8 buffers to PNG with maximum compression (the reference
// uses AV_CODEC_ID_PNG at max compression — imagefileio.rs:217-271) or to
// JPEG by file extension.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (reforge_tpu/io/imagefile.py); build with `make -C native`.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

namespace {

void set_err(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

std::string av_errstr(int code) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(code, buf, sizeof(buf));
  return std::string(buf);
}

}  // namespace

extern "C" {

struct RfDecoder {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *codec = nullptr;
  int stream_index = -1;
  int width = 0;
  int height = 0;
};

// Open a file and prepare its best video stream for decoding.
// Returns nullptr on failure with a message in err.
RfDecoder *rf_decoder_open(const char *path, char *err, int errlen) {
  RfDecoder *d = new RfDecoder();
  int ret = avformat_open_input(&d->fmt, path, nullptr, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "Failed to open '" + std::string(path) + "': " + av_errstr(ret));
    delete d;
    return nullptr;
  }
  ret = avformat_find_stream_info(d->fmt, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "No stream info: " + av_errstr(ret));
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  const AVCodec *dec = nullptr;
  ret = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (ret < 0 || !dec) {
    set_err(err, errlen, "No decodable video/image stream in '" + std::string(path) + "'");
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->stream_index = ret;
  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec, d->fmt->streams[d->stream_index]->codecpar);
  ret = avcodec_open2(d->codec, dec, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "Failed to open codec: " + av_errstr(ret));
    avcodec_free_context(&d->codec);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->width = d->codec->width;
  d->height = d->codec->height;
  return d;
}

void rf_decoder_dims(RfDecoder *d, int *w, int *h) {
  *w = d->width;
  *h = d->height;
}

// Decode the first frame, Lanczos-rescale to (out_w, out_h) RGBA8 and write
// tightly packed rows into `out` (out_w*out_h*4 bytes). Returns 0 on
// success.
int rf_decoder_decode(RfDecoder *d, uint8_t *out, int out_w, int out_h,
                      char *err, int errlen) {
  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  int ret = 0;
  bool got = false;

  while (!got && (ret = av_read_frame(d->fmt, pkt)) >= 0) {
    if (pkt->stream_index != d->stream_index) {
      av_packet_unref(pkt);
      continue;
    }
    ret = avcodec_send_packet(d->codec, pkt);
    av_packet_unref(pkt);
    if (ret < 0) break;
    ret = avcodec_receive_frame(d->codec, frame);
    if (ret == 0) {
      got = true;
    } else if (ret != AVERROR(EAGAIN)) {
      break;
    }
  }
  if (!got) {
    // Flush-mode for single-image codecs that buffer.
    avcodec_send_packet(d->codec, nullptr);
    got = avcodec_receive_frame(d->codec, frame) == 0;
  }
  if (!got) {
    set_err(err, errlen, "Failed to decode a frame: " + av_errstr(ret));
    av_frame_free(&frame);
    av_packet_free(&pkt);
    return -1;
  }

  // Lanczos resample + convert to RGBA8, exactly the reference's sws_scale
  // configuration (imagefileio.rs:156-174).
  SwsContext *sws = sws_getContext(
      frame->width, frame->height, (AVPixelFormat)frame->format, out_w, out_h,
      AV_PIX_FMT_RGBA, SWS_LANCZOS, nullptr, nullptr, nullptr);
  if (!sws) {
    set_err(err, errlen, "sws_getContext failed");
    av_frame_free(&frame);
    av_packet_free(&pkt);
    return -1;
  }
  uint8_t *dst_planes[4] = {out, nullptr, nullptr, nullptr};
  int dst_strides[4] = {out_w * 4, 0, 0, 0};
  sws_scale(sws, frame->data, frame->linesize, 0, frame->height, dst_planes,
            dst_strides);
  sws_freeContext(sws);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return 0;
}

void rf_decoder_close(RfDecoder *d) {
  if (!d) return;
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// Encode a tightly packed RGBA8 buffer to `path`. Codec chosen by
// extension: .png -> PNG (max compression, like the reference's encoder at
// imagefileio.rs:237-241), .jpg/.jpeg -> MJPEG at high quality.
int rf_encode(const char *path, const uint8_t *rgba, int w, int h, char *err,
              int errlen) {
  const char *dot = std::strrchr(path, '.');
  std::string ext = dot ? std::string(dot + 1) : "png";
  for (auto &c : ext) c = (char)std::tolower(c);
  bool jpeg = (ext == "jpg" || ext == "jpeg");

  AVCodecID codec_id = jpeg ? AV_CODEC_ID_MJPEG : AV_CODEC_ID_PNG;
  const AVCodec *enc = avcodec_find_encoder(codec_id);
  if (!enc) {
    set_err(err, errlen, "Encoder not available");
    return -1;
  }
  AVCodecContext *ctx = avcodec_alloc_context3(enc);
  ctx->width = w;
  ctx->height = h;
  ctx->time_base = {1, 25};
  if (jpeg) {
    ctx->pix_fmt = AV_PIX_FMT_YUVJ444P;
    ctx->flags |= AV_CODEC_FLAG_QSCALE;
    ctx->global_quality = FF_QP2LAMBDA * 2;  // high quality
  } else {
    ctx->pix_fmt = AV_PIX_FMT_RGBA;
    ctx->compression_level = 9;  // max compression, reference parity
    // Interlaced (Adam7) PNG, matching the reference encoder
    // (imagefileio.rs:239-241: AV_CODEC_FLAG_INTERLACED_DCT selects
    // interlacing in libav's pngenc.c).
    ctx->flags |= AV_CODEC_FLAG_INTERLACED_DCT;
  }

  int ret = avcodec_open2(ctx, enc, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "Failed to open encoder: " + av_errstr(ret));
    avcodec_free_context(&ctx);
    return -1;
  }

  AVFrame *frame = av_frame_alloc();
  frame->format = ctx->pix_fmt;
  frame->width = w;
  frame->height = h;
  av_frame_get_buffer(frame, 0);

  if (jpeg) {
    SwsContext *sws =
        sws_getContext(w, h, AV_PIX_FMT_RGBA, w, h, ctx->pix_fmt,
                       SWS_POINT, nullptr, nullptr, nullptr);
    const uint8_t *src_planes[4] = {rgba, nullptr, nullptr, nullptr};
    int src_strides[4] = {w * 4, 0, 0, 0};
    sws_scale(sws, src_planes, src_strides, 0, h, frame->data,
              frame->linesize);
    sws_freeContext(sws);
    frame->quality = ctx->global_quality;
  } else {
    for (int y = 0; y < h; y++) {
      std::memcpy(frame->data[0] + (size_t)y * frame->linesize[0],
                  rgba + (size_t)y * w * 4, (size_t)w * 4);
    }
  }

  AVPacket *pkt = av_packet_alloc();
  ret = avcodec_send_frame(ctx, frame);
  if (ret >= 0) ret = avcodec_send_frame(ctx, nullptr);
  if (ret >= 0) ret = avcodec_receive_packet(ctx, pkt);
  if (ret < 0) {
    set_err(err, errlen, "Encode failed: " + av_errstr(ret));
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&ctx);
    return -1;
  }

  FILE *f = std::fopen(path, "wb");
  if (!f) {
    set_err(err, errlen, "Cannot open output file '" + std::string(path) + "'");
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&ctx);
    return -1;
  }
  std::fwrite(pkt->data, 1, pkt->size, f);
  std::fclose(f);

  av_packet_free(&pkt);
  av_frame_free(&frame);
  avcodec_free_context(&ctx);
  return 0;
}

}  // extern "C"

// ---- Video streaming ----------------------------------------------------
//
// Beyond the reference (which decodes only the first frame of a video,
// imagefileio.rs:129-152): sequential full-video decode and encode, so the
// engine can stream every frame of a clip through the graph.

extern "C" {

// Seek the stream to ~`seconds` (lands on the preceding keyframe; callers
// discard frames until the target pts for exact trims). Returns 0/-1.
int rf_decoder_seek(RfDecoder *d, double seconds, char *err, int errlen) {
  AVStream *st = d->fmt->streams[d->stream_index];
  int64_t ts = (int64_t)llround(seconds / av_q2d(st->time_base));
  int ret = av_seek_frame(d->fmt, d->stream_index, ts, AVSEEK_FLAG_BACKWARD);
  if (ret < 0) {
    set_err(err, errlen, "Seek failed: " + av_errstr(ret));
    return -1;
  }
  avcodec_flush_buffers(d->codec);
  return 0;
}

// Decode the NEXT frame into `out` (RGBA8 at out_w x out_h), reporting its
// presentation time in seconds via `pts_sec` (-1 when unknown; pass NULL to
// skip). Returns 0 on success, 1 on end-of-stream, -1 on error.
int rf_decoder_next2(RfDecoder *d, uint8_t *out, int out_w, int out_h,
                     double *pts_sec, char *err, int errlen) {
  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  int ret = 0;
  bool got = false;
  bool eof = false;

  while (!got) {
    ret = avcodec_receive_frame(d->codec, frame);
    if (ret == 0) {
      got = true;
      break;
    }
    if (ret == AVERROR_EOF) {
      eof = true;
      break;
    }
    if (ret != AVERROR(EAGAIN)) break;
    // Need more input.
    ret = av_read_frame(d->fmt, pkt);
    if (ret == AVERROR_EOF) {
      avcodec_send_packet(d->codec, nullptr);  // flush
      continue;
    }
    if (ret < 0) break;
    if (pkt->stream_index == d->stream_index) {
      ret = avcodec_send_packet(d->codec, pkt);
      av_packet_unref(pkt);
      if (ret < 0) break;
    } else {
      av_packet_unref(pkt);
    }
  }

  if (eof || !got) {
    av_frame_free(&frame);
    av_packet_free(&pkt);
    if (eof) return 1;
    set_err(err, errlen, "Failed to decode next frame: " + av_errstr(ret));
    return -1;
  }

  if (pts_sec) {
    int64_t pts = frame->best_effort_timestamp;
    if (pts == AV_NOPTS_VALUE) pts = frame->pts;
    AVStream *st = d->fmt->streams[d->stream_index];
    *pts_sec = (pts == AV_NOPTS_VALUE) ? -1.0 : pts * av_q2d(st->time_base);
  }

  SwsContext *sws = sws_getContext(
      frame->width, frame->height, (AVPixelFormat)frame->format, out_w, out_h,
      AV_PIX_FMT_RGBA, SWS_LANCZOS, nullptr, nullptr, nullptr);
  uint8_t *dst_planes[4] = {out, nullptr, nullptr, nullptr};
  int dst_strides[4] = {out_w * 4, 0, 0, 0};
  sws_scale(sws, frame->data, frame->linesize, 0, frame->height, dst_planes,
            dst_strides);
  sws_freeContext(sws);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return 0;
}

// Back-compat wrapper without the pts report.
int rf_decoder_next(RfDecoder *d, uint8_t *out, int out_w, int out_h,
                    char *err, int errlen) {
  return rf_decoder_next2(d, out, out_w, out_h, nullptr, err, errlen);
}

// Frame rate of the stream (0 if unknown).
double rf_decoder_fps(RfDecoder *d) {
  AVRational r = d->fmt->streams[d->stream_index]->avg_frame_rate;
  if (r.num <= 0 || r.den <= 0) return 0.0;
  return (double)r.num / (double)r.den;
}

struct RfVideoEnc {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *codec = nullptr;
  AVStream *stream = nullptr;
  SwsContext *sws = nullptr;
  int w = 0, h = 0;
  int64_t next_pts = 0;
};

RfVideoEnc *rf_venc_open(const char *path, int w, int h, double fps, char *err,
                         int errlen) {
  RfVideoEnc *e = new RfVideoEnc();
  e->w = w;
  e->h = h;
  if (fps <= 0) fps = 30.0;

  int ret = avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
  if (ret < 0 || !e->fmt) {
    set_err(err, errlen, "Cannot create output container for '" +
                             std::string(path) + "': " + av_errstr(ret));
    delete e;
    return nullptr;
  }
  // Prefer the container's default video codec; fall back to MPEG-4 part 2
  // (always built into libavcodec, unlike x264).
  AVCodecID cid = e->fmt->oformat->video_codec;
  const AVCodec *enc = avcodec_find_encoder(cid);
  if (!enc) {
    cid = AV_CODEC_ID_MPEG4;
    enc = avcodec_find_encoder(cid);
  }
  if (!enc) {
    set_err(err, errlen, "No video encoder available");
    avformat_free_context(e->fmt);
    delete e;
    return nullptr;
  }
  e->stream = avformat_new_stream(e->fmt, nullptr);
  e->codec = avcodec_alloc_context3(enc);
  e->codec->width = w;
  e->codec->height = h;
  e->codec->time_base = av_d2q(1.0 / fps, 100000);
  e->codec->framerate = av_d2q(fps, 100000);
  e->codec->pix_fmt = AV_PIX_FMT_YUV420P;
  e->codec->bit_rate = (int64_t)w * h * 8;  // generous quality
  e->codec->gop_size = 12;
  // Frame-exact output beats compression for a processing tool: B-frames
  // can drop a trailing frame at the container boundary in some decoders.
  e->codec->max_b_frames = 0;
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  ret = avcodec_open2(e->codec, enc, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "Cannot open video encoder: " + av_errstr(ret));
    avcodec_free_context(&e->codec);
    avformat_free_context(e->fmt);
    delete e;
    return nullptr;
  }
  avcodec_parameters_from_context(e->stream->codecpar, e->codec);
  e->stream->time_base = e->codec->time_base;

  if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) {
    ret = avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE);
    if (ret < 0) {
      set_err(err, errlen, "Cannot open '" + std::string(path) +
                               "': " + av_errstr(ret));
      avcodec_free_context(&e->codec);
      avformat_free_context(e->fmt);
      delete e;
      return nullptr;
    }
  }
  ret = avformat_write_header(e->fmt, nullptr);
  if (ret < 0) {
    set_err(err, errlen, "Cannot write container header: " + av_errstr(ret));
    avcodec_free_context(&e->codec);
    avformat_free_context(e->fmt);
    delete e;
    return nullptr;
  }
  e->sws = sws_getContext(w, h, AV_PIX_FMT_RGBA, w, h, AV_PIX_FMT_YUV420P,
                          SWS_BICUBIC, nullptr, nullptr, nullptr);
  return e;
}

static int venc_drain(RfVideoEnc *e, char *err, int errlen) {
  AVPacket *pkt = av_packet_alloc();
  int ret;
  while ((ret = avcodec_receive_packet(e->codec, pkt)) == 0) {
    av_packet_rescale_ts(pkt, e->codec->time_base, e->stream->time_base);
    pkt->stream_index = e->stream->index;
    // MP4 derives the last sample's duration from the stts table; a
    // zero-duration final packet gets dropped by some demuxers.
    if (pkt->duration <= 0)
      pkt->duration = av_rescale_q(1, e->codec->time_base, e->stream->time_base);
    int wret = av_interleaved_write_frame(e->fmt, pkt);
    if (wret < 0) {
      set_err(err, errlen, "Write failed: " + av_errstr(wret));
      av_packet_free(&pkt);
      return -1;
    }
  }
  av_packet_free(&pkt);
  if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
  set_err(err, errlen, "Encode failed: " + av_errstr(ret));
  return -1;
}

int rf_venc_write(RfVideoEnc *e, const uint8_t *rgba, char *err, int errlen) {
  AVFrame *frame = av_frame_alloc();
  frame->format = AV_PIX_FMT_YUV420P;
  frame->width = e->w;
  frame->height = e->h;
  av_frame_get_buffer(frame, 0);
  const uint8_t *src_planes[4] = {rgba, nullptr, nullptr, nullptr};
  int src_strides[4] = {e->w * 4, 0, 0, 0};
  sws_scale(e->sws, src_planes, src_strides, 0, e->h, frame->data,
            frame->linesize);
  frame->pts = e->next_pts++;
  int ret = avcodec_send_frame(e->codec, frame);
  av_frame_free(&frame);
  if (ret < 0) {
    set_err(err, errlen, "Encode failed: " + av_errstr(ret));
    return -1;
  }
  return venc_drain(e, err, errlen);
}

int rf_venc_close(RfVideoEnc *e, char *err, int errlen) {
  int rc = 0;
  avcodec_send_frame(e->codec, nullptr);
  if (venc_drain(e, err, errlen) < 0) rc = -1;
  if (av_write_trailer(e->fmt) < 0) rc = -1;
  if (e->sws) sws_freeContext(e->sws);
  if (!(e->fmt->oformat->flags & AVFMT_NOFILE) && e->fmt->pb)
    avio_closep(&e->fmt->pb);
  avcodec_free_context(&e->codec);
  avformat_free_context(e->fmt);
  delete e;
  return rc;
}

}  // extern "C"
