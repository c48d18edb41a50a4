// videodecode — native video-container decode + face-crop + resize +
// normalize for the raw-video front end (SURVEY.md §2.7.1: the reference's
// external pipeline decodes videos and face-crops with margin before any
// training; call sites reference train_CNN.py:172-173).
//
// libavformat/libavcodec demux+decode (FFmpeg 5.x send/receive API) with
// in-codec frame threading; crop is applied as plane-pointer offsets on
// the decoded YUV frame (zero-copy), and libswscale converts
// cropped-YUV -> RGB24 at the target size with SWS_AREA (area-averaged
// downscale ≈ PIL's antialiased BILINEAR — see ADVICE r1 on the image
// loader's divergence). One call decodes ONE video sequentially and
// scatters every requested frame index into the caller's buffer, so a
// whole clip (or all clips of a video) costs a single demux pass.
//
// C ABI (ctypes; all functions return <0 on hard failure):
//   int video_probe(const char* path, int* n_frames, int* w, int* h,
//                   double* fps);
//     n_frames is best-effort (container metadata, else duration*fps,
//     else -1: caller must decode to count).
//   int video_decode_indices(const char* path, const int* indices, int n,
//                            const int* crops, int out_size, float mean,
//                            float std, float* out, int* ret_indices);
//     indices: n ascending presentation-order frame numbers.
//     crops: NULL or n*4 ints (y0, x0, h, w) in source pixels (applied
//            before resize; clamped; x0/y0 rounded down to even for 4:2:0
//            chroma alignment).
//     out: n * out_size * out_size * 3 f32, value = (x/255 - mean)/std.
//     Returns the number of frames filled (trailing indices past EOF are
//     zeroed).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>
}

#include <cstring>
#include <vector>

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream = -1;

  ~Reader() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    const AVCodec* codec = nullptr;
    stream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (stream < 0 || !codec) return -3;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return -4;
    if (avcodec_parameters_to_context(dec, fmt->streams[stream]->codecpar) < 0)
      return -5;
    dec->thread_count = 0;  // auto: frame/slice threading inside the codec
    if (avcodec_open2(dec, codec, nullptr) < 0) return -6;
    return 0;
  }
};

// normalize one RGB24 row-major image into (x/255 - mean)/std f32
void normalize_rgb(const uint8_t* rgb, int linesize, int size, float mean,
                   float std_, float* out) {
  const float inv = 1.0f / (255.0f * std_);
  const float bias = -mean / std_;
  for (int y = 0; y < size; y++) {
    const uint8_t* src = rgb + size_t(y) * linesize;
    float* dst = out + size_t(y) * size * 3;
    const int n = size * 3;
    for (int i = 0; i < n; i++) dst[i] = src[i] * inv + bias;
  }
}

}  // namespace

extern "C" {

int video_probe(const char* path, int* n_frames, int* w, int* h,
                double* fps) {
  Reader r;
  int rc = r.open(path);
  if (rc < 0) return rc;
  AVStream* st = r.fmt->streams[r.stream];
  *w = r.dec->width;
  *h = r.dec->height;
  AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate
                                         : st->r_frame_rate;
  *fps = fr.den ? double(fr.num) / fr.den : 0.0;
  if (st->nb_frames > 0) {
    *n_frames = int(st->nb_frames);
  } else if (st->duration > 0 && fr.den) {
    double secs = st->duration * av_q2d(st->time_base);
    *n_frames = int(secs * (*fps) + 0.5);
  } else if (r.fmt->duration > 0 && fr.den) {
    *n_frames = int(r.fmt->duration / double(AV_TIME_BASE) * (*fps) + 0.5);
  } else {
    *n_frames = -1;
  }
  return 0;
}

int video_count_frames(const char* path) {
  // Exact frame count by decoding the whole stream (for containers whose
  // metadata carries neither nb_frames nor a usable duration).
  Reader r;
  if (r.open(path) < 0) return -1;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int count = 0, eof_sent = 0;
  while (true) {
    int got = avcodec_receive_frame(r.dec, frame);
    if (got == AVERROR(EAGAIN)) {
      if (eof_sent) break;
      while (true) {
        int rr = av_read_frame(r.fmt, pkt);
        if (rr < 0) {
          avcodec_send_packet(r.dec, nullptr);
          eof_sent = 1;
          break;
        }
        if (pkt->stream_index != r.stream) {
          av_packet_unref(pkt);
          continue;
        }
        avcodec_send_packet(r.dec, pkt);
        av_packet_unref(pkt);
        break;
      }
      continue;
    }
    if (got < 0) break;
    count++;
    av_frame_unref(frame);
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return count;
}

int video_decode_indices(const char* path, const int* indices, int n,
                         const int* crops, int out_size, float mean,
                         float std_, float* out, int* /*ret_indices*/) {
  if (n <= 0) return 0;
  Reader r;
  if (r.open(path) < 0) return -1;

  const size_t slot = size_t(out_size) * out_size * 3;
  memset(out, 0, slot * n * sizeof(float));

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  std::vector<uint8_t> rgb(size_t(out_size) * out_size * 3 + 64);
  uint8_t* rgb_data[4] = {rgb.data(), nullptr, nullptr, nullptr};
  int rgb_lines[4] = {out_size * 3, 0, 0, 0};
  SwsContext* sws = nullptr;
  int sws_w = -1, sws_h = -1;
  AVPixelFormat sws_fmt = AV_PIX_FMT_NONE;

  // Canonical send/receive pump: drain EVERY pending frame before the
  // next packet (one packet can yield several frames under frame
  // threading), and only feed a packet after receive returns EAGAIN —
  // per the FFmpeg API contract send cannot then reject it, so no
  // packet (and no frame-number alignment) is ever silently dropped.
  int frame_no = 0, next = 0, filled = 0, eof_sent = 0;
  while (next < n) {
    int got = avcodec_receive_frame(r.dec, frame);
    if (got == AVERROR(EAGAIN)) {
      if (eof_sent) break;
      while (true) {
        int rr = av_read_frame(r.fmt, pkt);
        if (rr < 0) {
          avcodec_send_packet(r.dec, nullptr);  // flush
          eof_sent = 1;
          break;
        }
        if (pkt->stream_index != r.stream) {
          av_packet_unref(pkt);
          continue;
        }
        avcodec_send_packet(r.dec, pkt);
        av_packet_unref(pkt);
        break;
      }
      continue;
    }
    if (got < 0) break;  // AVERROR_EOF or error

    while (next < n && indices[next] == frame_no) {
      // crop by plane-pointer offset (even-aligned for subsampled chroma)
      const AVPixFmtDescriptor* desc =
          av_pix_fmt_desc_get(AVPixelFormat(frame->format));
      int y0 = 0, x0 = 0, ch = frame->height, cw = frame->width;
      if (crops) {
        y0 = crops[next * 4 + 0] & ~1;
        x0 = crops[next * 4 + 1] & ~1;
        ch = crops[next * 4 + 2];
        cw = crops[next * 4 + 3];
        if (y0 < 0) y0 = 0;
        if (x0 < 0) x0 = 0;
        if (y0 + ch > frame->height) ch = frame->height - y0;
        if (x0 + cw > frame->width) cw = frame->width - x0;
        if (ch < 2 || cw < 2) { y0 = x0 = 0; ch = frame->height; cw = frame->width; }
      }
      const uint8_t* planes[4];
      for (int p = 0; p < 4; p++) {
        planes[p] = frame->data[p];
        if (!planes[p]) continue;
        int sx = 0, sy = 0;
        if (desc && p >= 1 && p <= 2 &&
            !(desc->flags & AV_PIX_FMT_FLAG_RGB)) {
          sx = desc->log2_chroma_w;
          sy = desc->log2_chroma_h;
        }
        // bytes between horizontally adjacent samples in this plane
        int step = 1;
        if (desc)
          for (int c = 0; c < desc->nb_components; c++)
            if (desc->comp[c].plane == p) { step = desc->comp[c].step; break; }
        planes[p] = frame->data[p] + (size_t(y0) >> sy) * frame->linesize[p]
                    + (size_t(x0) >> sx) * step;
      }
      if (!sws || sws_w != cw || sws_h != ch ||
          sws_fmt != AVPixelFormat(frame->format)) {
        if (sws) sws_freeContext(sws);
        sws = sws_getContext(cw, ch, AVPixelFormat(frame->format), out_size,
                             out_size, AV_PIX_FMT_RGB24,
                             SWS_AREA, nullptr, nullptr, nullptr);
        sws_w = cw;
        sws_h = ch;
        sws_fmt = AVPixelFormat(frame->format);
      }
      if (!sws) break;
      sws_scale(sws, planes, frame->linesize, 0, ch, rgb_data, rgb_lines);
      normalize_rgb(rgb.data(), out_size * 3, out_size, mean, std_,
                    out + slot * next);
      filled++;
      next++;
    }
    frame_no++;
    av_frame_unref(frame);
  }

  if (sws) sws_freeContext(sws);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return filled;
}

}  // extern "C"
