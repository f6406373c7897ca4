/* rav1e-compatible C API for the PyTorch/CUDA port of the encoder.
 *
 * Reference parity: librav1e 0.5.1's exported C ABI (the 36 rav1e_*
 * functions listed in SURVEY.md Appendix A.5; rav1e src/capi.rs).
 * Same names, same call shapes, same status-code semantics, so C
 * users of librav1e can relink against librav1e_torch.so.
 *
 * The implementation embeds CPython and drives the port's session
 * (rav1e_tpu_torch/capi/bridge.py); compute runs on the CUDA card
 * through PyTorch, or on the CPU with
 * rav1e_config_parse(cfg, "device", "cpu").
 */
#ifndef RAV1E_TORCH_CAPI_H
#define RAV1E_TORCH_CAPI_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct RaConfig RaConfig;
typedef struct RaContext RaContext;
typedef struct RaFrame RaFrame;

typedef enum RaEncoderStatus {
  RA_ENCODER_STATUS_SUCCESS = 0,
  RA_ENCODER_STATUS_NEED_MORE_DATA,
  RA_ENCODER_STATUS_ENOUGH_DATA,
  RA_ENCODER_STATUS_LIMIT_REACHED,
  RA_ENCODER_STATUS_ENCODED,
  RA_ENCODER_STATUS_FAILURE = -1,
} RaEncoderStatus;

typedef enum RaFrameType {
  RA_FRAME_TYPE_KEY = 0,
  RA_FRAME_TYPE_INTER,
  RA_FRAME_TYPE_INTRA_ONLY,
  RA_FRAME_TYPE_SWITCH,
} RaFrameType;

typedef enum RaFrameTypeOverride {
  RA_FRAME_TYPE_OVERRIDE_NO = 0,
  RA_FRAME_TYPE_OVERRIDE_KEY,
} RaFrameTypeOverride;

typedef enum RaChromaSampling {
  RA_CHROMA_SAMPLING_CS420 = 0,
  RA_CHROMA_SAMPLING_CS422,
  RA_CHROMA_SAMPLING_CS444,
  RA_CHROMA_SAMPLING_CS400,
} RaChromaSampling;

typedef enum RaChromaSamplePosition {
  RA_CHROMA_SAMPLE_POSITION_UNKNOWN = 0,
  RA_CHROMA_SAMPLE_POSITION_VERTICAL,
  RA_CHROMA_SAMPLE_POSITION_COLOCATED,
} RaChromaSamplePosition;

typedef enum RaPixelRange {
  RA_PIXEL_RANGE_LIMITED = 0,
  RA_PIXEL_RANGE_FULL,
} RaPixelRange;

typedef struct RaPacket {
  const uint8_t *data;
  size_t len;
  uint64_t input_frameno;
  RaFrameType frame_type;
  void *opaque;
} RaPacket;

typedef struct RaData {
  const uint8_t *data;
  size_t len;
} RaData;

typedef struct RaChromaticityPoint {
  uint16_t x; /* 0.16 fixed-point CIE x */
  uint16_t y;
} RaChromaticityPoint;

typedef void (*RaFrameOpaqueCb)(void *);

/* -- config ---------------------------------------------------------- */
RaConfig *rav1e_config_default(void);
int rav1e_config_parse(RaConfig *cfg, const char *key, const char *value);
int rav1e_config_parse_int(RaConfig *cfg, const char *key, int value);
int rav1e_config_set_pixel_format(RaConfig *cfg, uint8_t bit_depth,
                                  RaChromaSampling subsampling,
                                  RaChromaSamplePosition position,
                                  RaPixelRange range);
int rav1e_config_set_color_description(RaConfig *cfg, uint8_t matrix,
                                       uint8_t transfer, uint8_t primaries);
int rav1e_config_set_content_light(RaConfig *cfg, uint16_t max_cll,
                                   uint16_t max_fall);
int rav1e_config_set_mastering_display(RaConfig *cfg,
                                       RaChromaticityPoint primaries[3],
                                       RaChromaticityPoint white_point,
                                       uint32_t max_luminance,
                                       uint32_t min_luminance);
int rav1e_config_set_sample_aspect_ratio(RaConfig *cfg, uint64_t num,
                                         uint64_t den);
int rav1e_config_set_time_base(RaConfig *cfg, uint64_t num, uint64_t den);
int rav1e_config_set_emit_data(RaConfig *cfg, int emit);
int rav1e_config_set_rc_summary(RaConfig *cfg, const uint8_t *data,
                                size_t len);
void rav1e_config_unref(RaConfig *cfg);

/* -- context --------------------------------------------------------- */
RaContext *rav1e_context_new(const RaConfig *cfg);
void rav1e_context_unref(RaContext *ctx);
RaEncoderStatus rav1e_send_frame(RaContext *ctx, const RaFrame *frame);
RaEncoderStatus rav1e_receive_packet(RaContext *ctx, RaPacket **pkt);
void rav1e_packet_unref(RaPacket *pkt);
RaData *rav1e_container_sequence_header(const RaContext *ctx);
void rav1e_data_unref(RaData *data);
RaEncoderStatus rav1e_last_status(const RaContext *ctx);
const char *rav1e_status_to_str(RaEncoderStatus status);

/* -- frames ---------------------------------------------------------- */
RaFrame *rav1e_frame_new(const RaContext *ctx);
void rav1e_frame_fill_plane(RaFrame *frame, int plane,
                            const uint8_t *data, size_t data_len,
                            ptrdiff_t stride, int bytewidth);
int rav1e_frame_extract_plane(const RaFrame *frame, int plane,
                              uint8_t *data, size_t data_len,
                              ptrdiff_t stride, int bytewidth);
void rav1e_frame_set_type(RaFrame *frame, RaFrameTypeOverride type);
void rav1e_frame_set_opaque(RaFrame *frame, void *opaque,
                            RaFrameOpaqueCb cb);
void rav1e_frame_unref(RaFrame *frame);

/* -- two-pass rate control ------------------------------------------- */
int rav1e_twopass_out(RaContext *ctx, uint8_t **buf);
size_t rav1e_twopass_bytes_needed(RaContext *ctx);
int rav1e_twopass_in(RaContext *ctx, const uint8_t *buf, size_t len);
size_t rav1e_rc_summary_size(void);
int rav1e_rc_second_pass_data_required(const RaContext *ctx);
RaData *rav1e_rc_receive_pass_data(RaContext *ctx);
int rav1e_rc_send_pass_data(RaContext *ctx, const uint8_t *data,
                            size_t len);

/* -- misc ------------------------------------------------------------ */
const char *rav1e_version_short(void);
const char *rav1e_version_full(void);

#ifdef __cplusplus
}
#endif
#endif /* RAV1E_TORCH_CAPI_H */
