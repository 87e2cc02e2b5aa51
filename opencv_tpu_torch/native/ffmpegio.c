/* FFmpeg videoio adapter — compressed-video container backend.
 *
 * Architectural parity with the reference's FFmpeg capture/writer
 * backend (reference: modules/videoio/src/cap_ffmpeg.cpp:1,
 * cap_ffmpeg_impl.hpp): the reference does NOT implement MPEG-4/H.264/
 * VP9 codecs itself — it adapts libavformat/libavcodec.  This shim
 * occupies the same position for opencv_tpu_torch: demux + decode any
 * payload the system FFmpeg knows into BGR24 host frames (which then
 * enter the device pipeline), and encode/mux BGR24 frames back out.
 * A copy of opencv_tpu/native/ffmpegio.c; videoio_ffmpeg.py builds it
 * into opencv_tpu_torch/_build/.
 *
 * From-scratch codecs (MJPEG, HuffYUV, FFV1, raw) still take priority
 * in videoio.py; this adapter is the fallback tier for formats whose
 * specs are not derivable in-image (H.264, HEVC, VP9, MPEG-4 ASP).
 *
 * Built against the PUBLIC FFmpeg 5.x API only.
 */

#include <libavformat/avformat.h>
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Reader                                                              */
/* ------------------------------------------------------------------ */

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext  *dec;
    AVFrame         *frame;
    AVPacket        *pkt;
    struct SwsContext *sws;
    int   vstream;
    int   w, h;
    double fps;
    int64_t nframes;
    int64_t next_idx;   /* presentation index of the next frame read() yields */
    uint32_t fourcc;
    int   eof;
    int   pending;  /* r->frame holds an undelivered frame (post-seek) */
} FFReader;

static void ff_quiet(void) { av_log_set_level(AV_LOG_FATAL); }

void *ocvt_ff_reader_open(const char *path)
{
    ff_quiet();
    FFReader *r = (FFReader *)av_mallocz(sizeof(FFReader));
    if (!r) return NULL;
    if (avformat_open_input(&r->fmt, path, NULL, NULL) < 0) goto fail;
    if (avformat_find_stream_info(r->fmt, NULL) < 0) goto fail;
    const AVCodec *codec = NULL;
    r->vstream = av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                     &codec, 0);
    if (r->vstream < 0 || !codec) goto fail;
    AVStream *st = r->fmt->streams[r->vstream];
    r->dec = avcodec_alloc_context3(codec);
    if (!r->dec) goto fail;
    if (avcodec_parameters_to_context(r->dec, st->codecpar) < 0) goto fail;
    r->dec->thread_count = 0;  /* auto; FFmpeg video decoders stay bit-exact */
    if (avcodec_open2(r->dec, codec, NULL) < 0) goto fail;
    r->w = st->codecpar->width;
    r->h = st->codecpar->height;
    AVRational fr = av_guess_frame_rate(r->fmt, st, NULL);
    if (fr.num <= 0 || fr.den <= 0) fr = st->r_frame_rate;
    r->fps = (fr.num > 0 && fr.den > 0) ? av_q2d(fr) : 25.0;
    r->nframes = st->nb_frames;
    if (r->nframes <= 0 && st->duration > 0)
        r->nframes = (int64_t)(st->duration * av_q2d(st->time_base)
                               * r->fps + 0.5);
    if (r->nframes <= 0 && r->fmt->duration > 0)
        r->nframes = (int64_t)((double)r->fmt->duration / AV_TIME_BASE
                               * r->fps + 0.5);
    r->fourcc = st->codecpar->codec_tag;
    if (!r->fourcc) {
        /* derive a tag from the codec id, as the reference get(FOURCC) does */
        const struct AVCodecTag *tables[] =
            { avformat_get_riff_video_tags(), avformat_get_mov_video_tags(), 0 };
        r->fourcc = av_codec_get_tag(tables, st->codecpar->codec_id);
    }
    r->frame = av_frame_alloc();
    r->pkt = av_packet_alloc();
    if (!r->frame || !r->pkt) goto fail;
    r->next_idx = 0;
    return r;
fail:
    if (r->dec) avcodec_free_context(&r->dec);
    if (r->fmt) avformat_close_input(&r->fmt);
    if (r->frame) av_frame_free(&r->frame);
    if (r->pkt) av_packet_free(&r->pkt);
    av_free(r);
    return NULL;
}

void ocvt_ff_reader_info(void *h, int *w, int *hh, double *fps,
                         int64_t *nframes, uint32_t *fourcc)
{
    FFReader *r = (FFReader *)h;
    *w = r->w; *hh = r->h; *fps = r->fps;
    *nframes = r->nframes; *fourcc = r->fourcc;
}

/* decode next frame into r->frame; returns 1 ok, 0 eof/error */
static int reader_next_frame(FFReader *r)
{
    for (;;) {
        int ret = avcodec_receive_frame(r->dec, r->frame);
        if (ret == 0) {
            AVStream *st = r->fmt->streams[r->vstream];
            int64_t pts = r->frame->best_effort_timestamp;
            if (pts != AV_NOPTS_VALUE) {
                int64_t start = st->start_time == AV_NOPTS_VALUE
                                ? 0 : st->start_time;
                double idx = (double)(pts - start) * av_q2d(st->time_base)
                             * r->fps;
                r->next_idx = (int64_t)(idx + 0.5);
            }
            return 1;
        }
        if (ret == AVERROR_EOF) return 0;
        if (ret != AVERROR(EAGAIN)) return 0;
        if (r->eof) {
            /* already sent flush packet and drained */
            return 0;
        }
        /* feed more packets */
        for (;;) {
            ret = av_read_frame(r->fmt, r->pkt);
            if (ret < 0) {
                r->eof = 1;
                avcodec_send_packet(r->dec, NULL);  /* flush */
                break;
            }
            if (r->pkt->stream_index == r->vstream) {
                ret = avcodec_send_packet(r->dec, r->pkt);
                av_packet_unref(r->pkt);
                if (ret == 0 || ret == AVERROR(EAGAIN)) break;
                /* decode error on this packet: keep going */
            } else {
                av_packet_unref(r->pkt);
            }
        }
    }
}

int ocvt_ff_reader_read(void *h, uint8_t *bgr)
{
    FFReader *r = (FFReader *)h;
    if (r->pending)
        r->pending = 0;
    else if (!reader_next_frame(r))
        return 0;
    r->next_idx += 1;
    if (!bgr) return 1;  /* skip mode (grab without retrieve) */
    r->sws = sws_getCachedContext(r->sws, r->frame->width, r->frame->height,
                                  (enum AVPixelFormat)r->frame->format,
                                  r->w, r->h, AV_PIX_FMT_BGR24,
                                  SWS_BICUBIC, NULL, NULL, NULL);
    if (!r->sws) return 0;
    uint8_t *dst[4] = { bgr, NULL, NULL, NULL };
    int dstls[4] = { r->w * 3, 0, 0, 0 };
    sws_scale(r->sws, (const uint8_t * const *)r->frame->data,
              r->frame->linesize, 0, r->frame->height, dst, dstls);
    return 1;
}

int64_t ocvt_ff_reader_tell(void *h) { return ((FFReader *)h)->next_idx; }

/* frame-accurate positioning: keyframe seek + decode forward
 * (reference: cap_ffmpeg_impl.hpp CvCapture_FFMPEG::seek) */
int ocvt_ff_reader_seek(void *h, int64_t target)
{
    FFReader *r = (FFReader *)h;
    if (target == r->next_idx) return 1;
    r->pending = 0;
    AVStream *st = r->fmt->streams[r->vstream];
    int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
    /* aim slightly before the target to be safe with rounding */
    double sec = (target > 0 ? (double)target - 0.5 : 0.0) / r->fps;
    int64_t ts = start + (int64_t)(sec / av_q2d(st->time_base));
    if (av_seek_frame(r->fmt, r->vstream, ts, AVSEEK_FLAG_BACKWARD) < 0)
        return 0;
    avcodec_flush_buffers(r->dec);
    r->eof = 0;
    r->next_idx = -1;
    /* decode forward until the NEXT frame is the target */
    while (1) {
        if (!reader_next_frame(r)) return 0;
        /* r->next_idx now holds the index of the frame just decoded */
        if (r->next_idx < 0) r->next_idx = 0;  /* no pts: trust the seek */
        if (r->next_idx >= target) {
            /* frame is buffered in r->frame; re-deliver it on next read:
             * push it back by remembering we already decoded it */
            r->pending = 1;
            return 1;
        }
        r->next_idx += 1;
    }
}

void ocvt_ff_reader_close(void *h)
{
    FFReader *r = (FFReader *)h;
    if (!r) return;
    if (r->sws) sws_freeContext(r->sws);
    if (r->dec) avcodec_free_context(&r->dec);
    if (r->fmt) avformat_close_input(&r->fmt);
    if (r->frame) av_frame_free(&r->frame);
    if (r->pkt) av_packet_free(&r->pkt);
    av_free(r);
}

/* ------------------------------------------------------------------ */
/* Writer                                                              */
/* ------------------------------------------------------------------ */

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext  *enc;
    AVStream        *st;
    AVFrame         *frame;
    AVPacket        *pkt;
    struct SwsContext *sws;
    int   w, h;
    int64_t count;
    int   header_written;
} FFWriter;

void *ocvt_ff_writer_open(const char *path, uint32_t fourcc, double fps,
                          int w, int h)
{
    ff_quiet();
    FFWriter *wr = (FFWriter *)av_mallocz(sizeof(FFWriter));
    if (!wr) return NULL;
    if (avformat_alloc_output_context2(&wr->fmt, NULL, NULL, path) < 0
        || !wr->fmt) goto fail;

    enum AVCodecID cid = AV_CODEC_ID_NONE;
    if (fourcc) {
        const struct AVCodecTag *tables[] =
            { avformat_get_riff_video_tags(), avformat_get_mov_video_tags(), 0 };
        cid = av_codec_get_id(tables, fourcc);
    }
    if (cid == AV_CODEC_ID_NONE)
        cid = av_guess_codec(wr->fmt->oformat, NULL, path, NULL,
                             AVMEDIA_TYPE_VIDEO);
    if (cid == AV_CODEC_ID_NONE) goto fail;
    const AVCodec *codec = avcodec_find_encoder(cid);
    if (!codec) goto fail;

    wr->st = avformat_new_stream(wr->fmt, NULL);
    if (!wr->st) goto fail;
    wr->enc = avcodec_alloc_context3(codec);
    if (!wr->enc) goto fail;

    AVRational q = av_d2q(fps > 0 ? fps : 25.0, 100000);
    wr->enc->codec_id = cid;
    wr->enc->width = w;
    wr->enc->height = h;
    wr->enc->time_base = (AVRational){ q.den, q.num };
    wr->enc->framerate = q;
    wr->enc->gop_size = 12;
    wr->enc->max_b_frames = 0;
    enum AVPixelFormat pf = AV_PIX_FMT_YUV420P;
    if (codec->pix_fmts) {
        pf = codec->pix_fmts[0];
        for (const enum AVPixelFormat *p = codec->pix_fmts;
             *p != AV_PIX_FMT_NONE; ++p)
            if (*p == AV_PIX_FMT_YUV420P) { pf = AV_PIX_FMT_YUV420P; break; }
    }
    wr->enc->pix_fmt = pf;
    if (pf == AV_PIX_FMT_YUVJ420P || pf == AV_PIX_FMT_YUVJ422P
        || pf == AV_PIX_FMT_YUVJ444P)
        wr->enc->color_range = AVCOL_RANGE_JPEG;
    /* bitrate heuristic in the same spirit as the reference writer's
     * default-quality path */
    int64_t br = (int64_t)((double)w * h * av_q2d(q) * 0.8);
    if (br < 400000) br = 400000;
    wr->enc->bit_rate = br;
    if (cid == AV_CODEC_ID_H264 || cid == AV_CODEC_ID_HEVC)
        av_opt_set(wr->enc->priv_data, "crf", "23", 0);
    if (wr->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        wr->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(wr->enc, codec, NULL) < 0) goto fail;
    if (avcodec_parameters_from_context(wr->st->codecpar, wr->enc) < 0)
        goto fail;
    wr->st->time_base = wr->enc->time_base;
    wr->st->avg_frame_rate = q;
    if (fourcc) wr->st->codecpar->codec_tag = 0;  /* let the muxer pick */

    if (!(wr->fmt->oformat->flags & AVFMT_NOFILE))
        if (avio_open(&wr->fmt->pb, path, AVIO_FLAG_WRITE) < 0) goto fail;
    if (avformat_write_header(wr->fmt, NULL) < 0) goto fail;
    wr->header_written = 1;

    wr->frame = av_frame_alloc();
    wr->pkt = av_packet_alloc();
    if (!wr->frame || !wr->pkt) goto fail;
    wr->frame->format = pf;
    wr->frame->width = w;
    wr->frame->height = h;
    if (av_frame_get_buffer(wr->frame, 0) < 0) goto fail;
    wr->w = w; wr->h = h;
    return wr;
fail:
    if (wr->enc) avcodec_free_context(&wr->enc);
    if (wr->fmt) {
        if (wr->fmt->pb) avio_closep(&wr->fmt->pb);
        avformat_free_context(wr->fmt);
    }
    if (wr->frame) av_frame_free(&wr->frame);
    if (wr->pkt) av_packet_free(&wr->pkt);
    av_free(wr);
    return NULL;
}

static int writer_drain(FFWriter *wr)
{
    for (;;) {
        int ret = avcodec_receive_packet(wr->enc, wr->pkt);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 1;
        if (ret < 0) return 0;
        av_packet_rescale_ts(wr->pkt, wr->enc->time_base, wr->st->time_base);
        wr->pkt->stream_index = wr->st->index;
        if (av_interleaved_write_frame(wr->fmt, wr->pkt) < 0) return 0;
    }
}

int ocvt_ff_writer_write(void *h, const uint8_t *bgr)
{
    FFWriter *wr = (FFWriter *)h;
    if (av_frame_make_writable(wr->frame) < 0) return 0;
    wr->sws = sws_getCachedContext(wr->sws, wr->w, wr->h, AV_PIX_FMT_BGR24,
                                   wr->w, wr->h,
                                   (enum AVPixelFormat)wr->frame->format,
                                   SWS_BICUBIC, NULL, NULL, NULL);
    if (!wr->sws) return 0;
    const uint8_t *src[4] = { bgr, NULL, NULL, NULL };
    int srcls[4] = { wr->w * 3, 0, 0, 0 };
    sws_scale(wr->sws, src, srcls, 0, wr->h, wr->frame->data,
              wr->frame->linesize);
    wr->frame->pts = wr->count++;
    if (avcodec_send_frame(wr->enc, wr->frame) < 0) return 0;
    return writer_drain(wr);
}

int ocvt_ff_writer_close(void *h)
{
    FFWriter *wr = (FFWriter *)h;
    if (!wr) return 0;
    int ok = 1;
    if (wr->header_written) {
        avcodec_send_frame(wr->enc, NULL);
        ok = writer_drain(wr);
        av_write_trailer(wr->fmt);
    }
    if (wr->sws) sws_freeContext(wr->sws);
    if (wr->enc) avcodec_free_context(&wr->enc);
    if (wr->fmt) {
        if (wr->fmt->pb) avio_closep(&wr->fmt->pb);
        avformat_free_context(wr->fmt);
    }
    if (wr->frame) av_frame_free(&wr->frame);
    if (wr->pkt) av_packet_free(&wr->pkt);
    av_free(wr);
    return ok;
}

unsigned ocvt_ff_version(void) { return avformat_version(); }

/* Raw yuv420p plane readout — plane-level oracle for the from-scratch
 * MPEG-4 decoder (imgcodecs/mpeg4.py).  Returns 1 and fills y/u/v if
 * the next decoded frame is 4:2:0 8-bit, else 0. */
int ocvt_ff_reader_read_yuv420(void *h, uint8_t *yp, uint8_t *up,
                               uint8_t *vp)
{
    FFReader *r = (FFReader *)h;
    if (r->pending)
        r->pending = 0;
    else if (!reader_next_frame(r))
        return 0;
    r->next_idx += 1;
    if (r->frame->format != AV_PIX_FMT_YUV420P
        && r->frame->format != AV_PIX_FMT_YUVJ420P)
        return 0;
    int w = r->frame->width, hh = r->frame->height;
    for (int i = 0; i < hh; i++)
        memcpy(yp + (size_t)i * w, r->frame->data[0]
               + (size_t)i * r->frame->linesize[0], w);
    for (int i = 0; i < hh / 2; i++) {
        memcpy(up + (size_t)i * (w / 2), r->frame->data[1]
               + (size_t)i * r->frame->linesize[1], w / 2);
        memcpy(vp + (size_t)i * (w / 2), r->frame->data[2]
               + (size_t)i * r->frame->linesize[2], w / 2);
    }
    return 1;
}

/* yuv420p -> BGR24 through swscale, so a from-scratch YUV decode can
 * produce the exact BGR bytes the FFmpeg-backend path produces. */
int ocvt_sws_yuv420p_to_bgr(const uint8_t *yp, const uint8_t *up,
                            const uint8_t *vp, int w, int h, uint8_t *bgr)
{
    struct SwsContext *sws = sws_getContext(
        w, h, AV_PIX_FMT_YUV420P, w, h, AV_PIX_FMT_BGR24,
        SWS_BICUBIC, NULL, NULL, NULL);
    if (!sws) return 0;
    const uint8_t *src[4] = { yp, up, vp, NULL };
    int srcls[4] = { w, w / 2, w / 2, 0 };
    uint8_t *dst[4] = { bgr, NULL, NULL, NULL };
    int dstls[4] = { w * 3, 0, 0, 0 };
    sws_scale(sws, src, srcls, 0, h, dst, dstls);
    sws_freeContext(sws);
    return 1;
}
