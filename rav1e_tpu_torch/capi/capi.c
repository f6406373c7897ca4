/* rav1e-compatible C ABI for the PyTorch/CUDA port of the encoder.
 *
 * Reference parity: librav1e 0.5.1's exported C API (36 rav1e_*
 * functions; SURVEY.md Appendix A.5, rav1e src/capi.rs). The shim
 * embeds CPython, imports rav1e_tpu_torch.capi.bridge, and marshals
 * plain buffers across the boundary; all encoding runs through the
 * port's normal session (PyTorch on the CUDA card, or on the CPU when
 * the config's "device" key says "cpu").
 *
 * Build (see rav1e_tpu_torch/capi/build.py):
 *   g++ -O2 -shared -fPIC capi.c -o librav1e_torch.so \
 *       $(python3-config --includes) \
 *       -L$LIBDIR -lpython3.12 -Wl,-rpath,$LIBDIR \
 *       -DRAV1E_TORCH_ROOT=\"<checkout>\" -DRAV1E_TORCH_PATH=\"<sys.path>\"
 *
 * RAV1E_TORCH_ROOT is the checkout that holds the package and
 * RAV1E_TORCH_PATH the building interpreter's module search path
 * (':'-separated), both added to sys.path when the shim boots its own
 * interpreter, so a standalone program finds torch as the building
 * Python does.
 *
 * Thread model: every entry point takes the GIL (PyGILState), so the
 * ABI is callable from any thread, one call at a time — same
 * effective serialization as librav1e's per-context mutability rules.
 */

#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "rav1e.h"

#ifndef RAV1E_TORCH_ROOT
#define RAV1E_TORCH_ROOT ""
#endif
#ifndef RAV1E_TORCH_PATH
#define RAV1E_TORCH_PATH ""
#endif

/* ---------------------------------------------------------------- */
/* embedded interpreter bootstrap                                   */

static PyObject *g_bridge = NULL; /* rav1e_tpu_torch.capi.bridge */

/* Append `dir` to sys.path unless it is there. */
static void path_add(PyObject *sys_path, const char *dir, Py_ssize_t n) {
  PyObject *item = PyUnicode_FromStringAndSize(dir, n);
  if (!item) {
    PyErr_Clear();
    return;
  }
  int found = PySequence_Contains(sys_path, item);
  if (found == 0) PyList_Append(sys_path, item);
  if (found < 0) PyErr_Clear();
  Py_DECREF(item);
}

static int ensure_bridge_locked(void) {
  /* caller holds the GIL */
  if (g_bridge) return 0;
  PyObject *sys_path = PySys_GetObject("path"); /* borrowed */
  if (sys_path && PyList_Check(sys_path)) {
    const char *root = RAV1E_TORCH_ROOT;
    if (root[0]) path_add(sys_path, root, (Py_ssize_t)strlen(root));
    const char *p = RAV1E_TORCH_PATH;
    while (*p) {
      const char *e = strchr(p, ':');
      Py_ssize_t n = e ? (Py_ssize_t)(e - p) : (Py_ssize_t)strlen(p);
      if (n > 0) path_add(sys_path, p, n);
      p += n + (e ? 1 : 0);
    }
  }
  g_bridge = PyImport_ImportModule("rav1e_tpu_torch.capi.bridge");
  if (!g_bridge) {
    PyErr_Print();
    return -1;
  }
  return 0;
}

static PyGILState_STATE capi_enter(void) {
  if (!Py_IsInitialized()) {
    /* standalone embedding (not loaded into a Python process) */
    Py_InitializeEx(0);
    /* release the GIL acquired by Py_Initialize so PyGILState works
     * uniformly below */
    PyEval_SaveThread();
  }
  return PyGILState_Ensure();
}

static void capi_leave(PyGILState_STATE st) { PyGILState_Release(st); }

/* ---------------------------------------------------------------- */
/* object layouts                                                   */

struct RaConfig {
  PyObject *kv; /* dict of str -> str */
};

struct RaContext {
  PyObject *session; /* bridge._Session */
  int width, height, bit_depth, ss_x, ss_y;
  RaEncoderStatus last;
};

struct RaFrame {
  int nplanes;
  uint8_t *planes[3];
  size_t plane_bytes[3];
  int pw[3], ph[3]; /* plane dims in samples */
  int bpp;          /* internal bytes per sample (1 or 2) */
  RaFrameType type_override; /* KEY when forced */
  int have_override;
  void *opaque;
  RaFrameOpaqueCb opaque_cb;
};

/* ---------------------------------------------------------------- */
/* config                                                           */

RaConfig *rav1e_config_default(void) {
  PyGILState_STATE st = capi_enter();
  RaConfig *cfg = (RaConfig *)calloc(1, sizeof(RaConfig));
  if (cfg) cfg->kv = PyDict_New();
  capi_leave(st);
  return cfg;
}

static int config_set_str(RaConfig *cfg, const char *key,
                          const char *value) {
  if (!cfg || !cfg->kv || !key || !value) return -1;
  PyGILState_STATE st = capi_enter();
  PyObject *v = PyUnicode_FromString(value);
  int rc = v ? PyDict_SetItemString(cfg->kv, key, v) : -1;
  Py_XDECREF(v);
  capi_leave(st);
  return rc ? -1 : 0;
}

int rav1e_config_parse(RaConfig *cfg, const char *key,
                       const char *value) {
  return config_set_str(cfg, key, value);
}

int rav1e_config_parse_int(RaConfig *cfg, const char *key, int value) {
  char buf[32];
  snprintf(buf, sizeof(buf), "%d", value);
  return config_set_str(cfg, key, buf);
}

int rav1e_config_set_pixel_format(RaConfig *cfg, uint8_t bit_depth,
                                  RaChromaSampling subsampling,
                                  RaChromaSamplePosition position,
                                  RaPixelRange range) {
  (void)position;
  if (bit_depth != 8 && bit_depth != 10 && bit_depth != 12) return -1;
  const char *cs;
  switch (subsampling) {
    case RA_CHROMA_SAMPLING_CS420: cs = "420"; break;
    case RA_CHROMA_SAMPLING_CS422: cs = "422"; break;
    case RA_CHROMA_SAMPLING_CS444: cs = "444"; break;
    default: return -1; /* 4:0:0 unsupported (rav1e: mono via Cs400) */
  }
  if (rav1e_config_parse_int(cfg, "bit_depth", bit_depth)) return -1;
  if (config_set_str(cfg, "chroma_sampling", cs)) return -1;
  return rav1e_config_parse_int(cfg, "color_range",
                                range == RA_PIXEL_RANGE_FULL ? 1 : 0);
}

int rav1e_config_set_color_description(RaConfig *cfg, uint8_t matrix,
                                       uint8_t transfer,
                                       uint8_t primaries) {
  char buf[48];
  snprintf(buf, sizeof(buf), "%u,%u,%u", primaries, transfer, matrix);
  return config_set_str(cfg, "color_description", buf);
}

int rav1e_config_set_content_light(RaConfig *cfg, uint16_t max_cll,
                                   uint16_t max_fall) {
  char buf[32];
  snprintf(buf, sizeof(buf), "%u,%u", max_cll, max_fall);
  return config_set_str(cfg, "content_light", buf);
}

int rav1e_config_set_mastering_display(RaConfig *cfg,
                                       RaChromaticityPoint primaries[3],
                                       RaChromaticityPoint white_point,
                                       uint32_t max_luminance,
                                       uint32_t min_luminance) {
  /* chromaticities arrive as 0.16 fixed point, luminance as 24.8 /
   * 18.14 per spec; bridge takes plain floats */
  char buf[256];
  snprintf(buf, sizeof(buf), "%g,%g,%g,%g,%g,%g,%g,%g,%g,%g",
           primaries[0].x / 65536.0, primaries[0].y / 65536.0,
           primaries[1].x / 65536.0, primaries[1].y / 65536.0,
           primaries[2].x / 65536.0, primaries[2].y / 65536.0,
           white_point.x / 65536.0, white_point.y / 65536.0,
           max_luminance / 256.0, min_luminance / 16384.0);
  return config_set_str(cfg, "mastering_display", buf);
}

int rav1e_config_set_sample_aspect_ratio(RaConfig *cfg, uint64_t num,
                                         uint64_t den) {
  char buf[64];
  snprintf(buf, sizeof(buf), "%llu/%llu", (unsigned long long)num,
           (unsigned long long)den);
  return config_set_str(cfg, "sample_aspect_ratio", buf);
}

int rav1e_config_set_time_base(RaConfig *cfg, uint64_t num,
                               uint64_t den) {
  char buf[64];
  snprintf(buf, sizeof(buf), "%llu/%llu", (unsigned long long)num,
           (unsigned long long)den);
  return config_set_str(cfg, "time_base", buf);
}

int rav1e_config_set_emit_data(RaConfig *cfg, int emit) {
  return rav1e_config_parse_int(cfg, "emit_data", emit ? 1 : 0);
}

int rav1e_config_set_rc_summary(RaConfig *cfg, const uint8_t *data,
                                size_t len) {
  if (!cfg || !cfg->kv || !data) return -1;
  PyGILState_STATE st = capi_enter();
  PyObject *v = PyBytes_FromStringAndSize((const char *)data,
                                          (Py_ssize_t)len);
  int rc = v ? PyDict_SetItemString(cfg->kv, "rc_summary", v) : -1;
  Py_XDECREF(v);
  capi_leave(st);
  return rc ? -1 : 0;
}

void rav1e_config_unref(RaConfig *cfg) {
  if (!cfg) return;
  PyGILState_STATE st = capi_enter();
  Py_XDECREF(cfg->kv);
  capi_leave(st);
  free(cfg);
}

/* ---------------------------------------------------------------- */
/* context                                                          */

RaContext *rav1e_context_new(const RaConfig *cfg) {
  if (!cfg || !cfg->kv) return NULL;
  PyGILState_STATE st = capi_enter();
  RaContext *ctx = NULL;
  if (ensure_bridge_locked() == 0) {
    PyObject *sess = PyObject_CallMethod(g_bridge, "context_new", "O",
                                         cfg->kv);
    if (!sess) {
      PyErr_Print();
    } else {
      PyObject *info =
          PyObject_CallMethod(g_bridge, "context_info", "O", sess);
      if (info && PyTuple_Check(info) && PyTuple_Size(info) == 5) {
        ctx = (RaContext *)calloc(1, sizeof(RaContext));
        ctx->session = sess;
        ctx->width = (int)PyLong_AsLong(PyTuple_GetItem(info, 0));
        ctx->height = (int)PyLong_AsLong(PyTuple_GetItem(info, 1));
        ctx->bit_depth = (int)PyLong_AsLong(PyTuple_GetItem(info, 2));
        ctx->ss_x = (int)PyLong_AsLong(PyTuple_GetItem(info, 3));
        ctx->ss_y = (int)PyLong_AsLong(PyTuple_GetItem(info, 4));
        ctx->last = RA_ENCODER_STATUS_SUCCESS;
      } else {
        PyErr_Print();
        Py_DECREF(sess);
      }
      Py_XDECREF(info);
    }
  }
  capi_leave(st);
  return ctx;
}

void rav1e_context_unref(RaContext *ctx) {
  if (!ctx) return;
  PyGILState_STATE st = capi_enter();
  Py_XDECREF(ctx->session);
  capi_leave(st);
  free(ctx);
}

RaEncoderStatus rav1e_send_frame(RaContext *ctx, const RaFrame *frame) {
  if (!ctx || !ctx->session) return RA_ENCODER_STATUS_FAILURE;
  PyGILState_STATE st = capi_enter();
  PyObject *planes;
  int override_key = 0;
  uintptr_t opaque = 0;
  if (frame) {
    planes = PyList_New(3);
    for (int i = 0; i < 3; i++) {
      PyObject *b = PyBytes_FromStringAndSize(
          (const char *)frame->planes[i],
          (Py_ssize_t)frame->plane_bytes[i]);
      PyList_SetItem(planes, i, b); /* steals */
    }
    override_key = frame->have_override &&
                   frame->type_override == RA_FRAME_TYPE_KEY;
    opaque = (uintptr_t)frame->opaque;
  } else {
    planes = Py_None;
    Py_INCREF(Py_None);
  }
  PyObject *r = PyObject_CallMethod(g_bridge, "send_frame", "OOiK",
                                    ctx->session, planes,
                                    override_key,
                                    (unsigned long long)opaque);
  Py_DECREF(planes);
  RaEncoderStatus rc = RA_ENCODER_STATUS_FAILURE;
  if (r) {
    rc = (RaEncoderStatus)PyLong_AsLong(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  ctx->last = rc;
  capi_leave(st);
  return rc;
}

RaEncoderStatus rav1e_receive_packet(RaContext *ctx, RaPacket **pkt) {
  if (!ctx || !ctx->session || !pkt) return RA_ENCODER_STATUS_FAILURE;
  *pkt = NULL;
  PyGILState_STATE st = capi_enter();
  RaEncoderStatus rc = RA_ENCODER_STATUS_FAILURE;
  PyObject *r = PyObject_CallMethod(g_bridge, "receive_packet", "O",
                                    ctx->session);
  if (r && PyTuple_Check(r) && PyTuple_Size(r) == 5) {
    rc = (RaEncoderStatus)PyLong_AsLong(PyTuple_GetItem(r, 0));
    PyObject *data = PyTuple_GetItem(r, 1);
    if (rc == RA_ENCODER_STATUS_SUCCESS && data != Py_None) {
      char *buf;
      Py_ssize_t len;
      if (PyBytes_AsStringAndSize(data, &buf, &len) == 0) {
        RaPacket *p = (RaPacket *)calloc(1, sizeof(RaPacket));
        uint8_t *copy = (uint8_t *)malloc((size_t)len ? (size_t)len : 1);
        memcpy(copy, buf, (size_t)len);
        p->data = copy;
        p->len = (size_t)len;
        p->input_frameno =
            (uint64_t)PyLong_AsUnsignedLongLong(PyTuple_GetItem(r, 2));
        p->frame_type =
            (RaFrameType)PyLong_AsLong(PyTuple_GetItem(r, 3));
        p->opaque = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(
            PyTuple_GetItem(r, 4));
        *pkt = p;
      } else {
        rc = RA_ENCODER_STATUS_FAILURE;
      }
    }
  } else if (!r) {
    PyErr_Print();
  }
  Py_XDECREF(r);
  ctx->last = rc;
  capi_leave(st);
  return rc;
}

void rav1e_packet_unref(RaPacket *pkt) {
  if (!pkt) return;
  free((void *)pkt->data);
  free(pkt);
}

RaData *rav1e_container_sequence_header(const RaContext *ctx) {
  if (!ctx || !ctx->session) return NULL;
  PyGILState_STATE st = capi_enter();
  RaData *out = NULL;
  PyObject *r = PyObject_CallMethod(g_bridge, "sequence_header", "O",
                                    ctx->session);
  char *buf;
  Py_ssize_t len;
  if (r && PyBytes_AsStringAndSize(r, &buf, &len) == 0) {
    out = (RaData *)calloc(1, sizeof(RaData));
    uint8_t *copy = (uint8_t *)malloc((size_t)len ? (size_t)len : 1);
    memcpy(copy, buf, (size_t)len);
    out->data = copy;
    out->len = (size_t)len;
  } else if (!r) {
    PyErr_Print();
  }
  Py_XDECREF(r);
  capi_leave(st);
  return out;
}

void rav1e_data_unref(RaData *data) {
  if (!data) return;
  free((void *)data->data);
  free(data);
}

RaEncoderStatus rav1e_last_status(const RaContext *ctx) {
  return ctx ? ctx->last : RA_ENCODER_STATUS_FAILURE;
}

const char *rav1e_status_to_str(RaEncoderStatus status) {
  switch (status) {
    case RA_ENCODER_STATUS_SUCCESS: return "success";
    case RA_ENCODER_STATUS_NEED_MORE_DATA: return "need more data";
    case RA_ENCODER_STATUS_ENOUGH_DATA: return "enough data";
    case RA_ENCODER_STATUS_LIMIT_REACHED: return "limit reached";
    case RA_ENCODER_STATUS_ENCODED: return "encoded";
    case RA_ENCODER_STATUS_FAILURE: return "failure";
  }
  return "unknown";
}

/* ---------------------------------------------------------------- */
/* frames                                                           */

RaFrame *rav1e_frame_new(const RaContext *ctx) {
  if (!ctx) return NULL;
  RaFrame *f = (RaFrame *)calloc(1, sizeof(RaFrame));
  if (!f) return NULL;
  f->nplanes = 3;
  f->bpp = ctx->bit_depth > 8 ? 2 : 1;
  int cw = (ctx->width + ctx->ss_x) >> ctx->ss_x;
  int ch = (ctx->height + ctx->ss_y) >> ctx->ss_y;
  int pw[3] = {ctx->width, cw, cw};
  int ph[3] = {ctx->height, ch, ch};
  for (int i = 0; i < 3; i++) {
    f->pw[i] = pw[i];
    f->ph[i] = ph[i];
    f->plane_bytes[i] = (size_t)pw[i] * ph[i] * f->bpp;
    f->planes[i] = (uint8_t *)calloc(1, f->plane_bytes[i]);
  }
  return f;
}

void rav1e_frame_fill_plane(RaFrame *frame, int plane,
                            const uint8_t *data, size_t data_len,
                            ptrdiff_t stride, int bytewidth) {
  if (!frame || plane < 0 || plane >= 3 || !data) return;
  int w = frame->pw[plane], h = frame->ph[plane];
  int bpp = frame->bpp;
  uint8_t *dst = frame->planes[plane];
  for (int r = 0; r < h; r++) {
    const uint8_t *srow = data + (ptrdiff_t)r * stride;
    if ((size_t)((srow - data) + (ptrdiff_t)w * bytewidth) >
        data_len)
      break;
    uint8_t *drow = dst + (size_t)r * w * bpp;
    if (bytewidth == bpp) {
      memcpy(drow, srow, (size_t)w * bpp);
    } else if (bytewidth == 1 && bpp == 2) {
      for (int c = 0; c < w; c++) {
        drow[2 * c] = srow[c];
        drow[2 * c + 1] = 0;
      }
    } else if (bytewidth == 2 && bpp == 1) {
      for (int c = 0; c < w; c++) drow[c] = srow[2 * c];
    }
  }
}

int rav1e_frame_extract_plane(const RaFrame *frame, int plane,
                              uint8_t *data, size_t data_len,
                              ptrdiff_t stride, int bytewidth) {
  if (!frame || plane < 0 || plane >= 3 || !data) return -1;
  int w = frame->pw[plane], h = frame->ph[plane];
  int bpp = frame->bpp;
  const uint8_t *src = frame->planes[plane];
  for (int r = 0; r < h; r++) {
    uint8_t *drow = data + (ptrdiff_t)r * stride;
    if ((size_t)((drow - data) + (ptrdiff_t)w * bytewidth) >
        data_len)
      return -1;
    const uint8_t *srow = src + (size_t)r * w * bpp;
    if (bytewidth == bpp) {
      memcpy(drow, srow, (size_t)w * bpp);
    } else if (bytewidth == 2 && bpp == 1) {
      for (int c = 0; c < w; c++) {
        drow[2 * c] = srow[c];
        drow[2 * c + 1] = 0;
      }
    } else if (bytewidth == 1 && bpp == 2) {
      for (int c = 0; c < w; c++) drow[c] = srow[2 * c];
    }
  }
  return 0;
}

void rav1e_frame_set_type(RaFrame *frame, RaFrameTypeOverride type) {
  if (!frame) return;
  frame->have_override = (type == RA_FRAME_TYPE_OVERRIDE_KEY);
  frame->type_override = RA_FRAME_TYPE_KEY;
}

void rav1e_frame_set_opaque(RaFrame *frame, void *opaque,
                            RaFrameOpaqueCb cb) {
  if (!frame) return;
  frame->opaque = opaque;
  frame->opaque_cb = cb;
}

void rav1e_frame_unref(RaFrame *frame) {
  if (!frame) return;
  for (int i = 0; i < 3; i++) free(frame->planes[i]);
  free(frame);
}

/* ---------------------------------------------------------------- */
/* two-pass rate control                                            */

static PyObject *call_bytes_method(RaContext *ctx, const char *name) {
  return PyObject_CallMethod(g_bridge, name, "O", ctx->session);
}

int rav1e_twopass_out(RaContext *ctx, uint8_t **buf) {
  if (!ctx || !ctx->session || !buf) return -1;
  *buf = NULL;
  PyGILState_STATE st = capi_enter();
  int n = -1;
  PyObject *r = call_bytes_method(ctx, "twopass_out");
  char *b;
  Py_ssize_t len;
  if (r && PyBytes_AsStringAndSize(r, &b, &len) == 0) {
    /* rav1e returns a pointer into context-owned storage; we malloc
     * and the caller frees via rav1e_data_unref-like free() — kept
     * context-owned here: stash on the context */
    uint8_t *copy = (uint8_t *)malloc((size_t)len ? (size_t)len : 1);
    memcpy(copy, b, (size_t)len);
    *buf = copy;
    n = (int)len;
  } else if (!r) {
    PyErr_Print();
  }
  Py_XDECREF(r);
  capi_leave(st);
  return n;
}

size_t rav1e_twopass_bytes_needed(RaContext *ctx) {
  if (!ctx || !ctx->session) return 0;
  PyGILState_STATE st = capi_enter();
  size_t n = 0;
  PyObject *r = call_bytes_method(ctx, "twopass_bytes_needed");
  if (r) {
    n = (size_t)PyLong_AsUnsignedLongLong(r);
    Py_DECREF(r);
  }
  capi_leave(st);
  return n;
}

int rav1e_twopass_in(RaContext *ctx, const uint8_t *buf, size_t len) {
  if (!ctx || !ctx->session || !buf) return -1;
  PyGILState_STATE st = capi_enter();
  int rc = -1;
  PyObject *r = PyObject_CallMethod(g_bridge, "twopass_in", "Oy#",
                                    ctx->session, (const char *)buf,
                                    (Py_ssize_t)len);
  if (r) {
    rc = (int)PyLong_AsLong(r);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  capi_leave(st);
  return rc;
}

size_t rav1e_rc_summary_size(void) {
  /* fixed summary struct: magic(4) + version(4) + 4 counts(4) +
   * 4 sums(8) + total(8) — mirror of rate/rc.py _SUMMARY */
  return 4 + 4 + 4 * 4 + 4 * 8 + 8;
}

int rav1e_rc_second_pass_data_required(const RaContext *ctx) {
  return rav1e_twopass_bytes_needed((RaContext *)ctx) > 0 ? 1 : 0;
}

RaData *rav1e_rc_receive_pass_data(RaContext *ctx) {
  if (!ctx || !ctx->session) return NULL;
  PyGILState_STATE st = capi_enter();
  RaData *out = NULL;
  PyObject *r = call_bytes_method(ctx, "twopass_out");
  char *b;
  Py_ssize_t len;
  if (r && PyBytes_AsStringAndSize(r, &b, &len) == 0 && len > 0) {
    out = (RaData *)calloc(1, sizeof(RaData));
    uint8_t *copy = (uint8_t *)malloc((size_t)len);
    memcpy(copy, b, (size_t)len);
    out->data = copy;
    out->len = (size_t)len;
  }
  Py_XDECREF(r);
  capi_leave(st);
  return out;
}

int rav1e_rc_send_pass_data(RaContext *ctx, const uint8_t *data,
                            size_t len) {
  return rav1e_twopass_in(ctx, data, len);
}

/* ---------------------------------------------------------------- */
/* misc                                                             */

const char *rav1e_version_short(void) { return "0.5.1-cuda"; }

const char *rav1e_version_full(void) {
  return "rav1e_tpu_torch 0.5.1 (rav1e-compatible C API, PyTorch/CUDA "
         "backend)";
}
