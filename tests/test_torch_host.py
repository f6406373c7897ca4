"""The port's host-side surfaces on the CPU: the rav1e-compatible C ABI
(rav1e_tpu_torch/capi, the shim built with g++ and driven through
ctypes and from a standalone C program) and the host modules copied from
the JAX package (analysis/quality.py, conform/parse.py,
conform/rav1e_ref.py), each held against the reference's functions on
the same inputs."""

import ctypes
import ctypes as ct
import gc
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from rav1e_tpu.analysis import quality as jq
from rav1e_tpu.conform import parse as jparse
from rav1e_tpu.conform import rav1e_ref as jref
from rav1e_tpu_torch.analysis import quality as tq
from rav1e_tpu_torch.api.context import Config
from rav1e_tpu_torch.capi.build import build
from rav1e_tpu_torch.conform import dav1d
from rav1e_tpu_torch.conform import parse as tparse
from rav1e_tpu_torch.conform import rav1e_ref as tref


@pytest.fixture(autouse=True, scope="module")
def _light_on_a_shared_worker():
    """Run torch on one thread and hand the worker's freed heap back to
    the system around the module (glibc's malloc_trim)."""
    _trim_heap()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _trim_heap()


def _trim_heap():
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        trim(0)


class _RaPacket(ct.Structure):
    _fields_ = [("data", ct.POINTER(ct.c_uint8)),
                ("len", ct.c_size_t),
                ("input_frameno", ct.c_uint64),
                ("frame_type", ct.c_int),
                ("opaque", ct.c_void_p)]


def _capi(path: Path):
    lib = ct.CDLL(str(path))
    lib.rav1e_config_default.restype = ct.c_void_p
    lib.rav1e_config_parse.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_char_p]
    lib.rav1e_config_parse_int.argtypes = [ct.c_void_p, ct.c_char_p,
                                           ct.c_int]
    lib.rav1e_context_new.argtypes = [ct.c_void_p]
    lib.rav1e_context_new.restype = ct.c_void_p
    lib.rav1e_frame_new.argtypes = [ct.c_void_p]
    lib.rav1e_frame_new.restype = ct.c_void_p
    lib.rav1e_frame_fill_plane.argtypes = [
        ct.c_void_p, ct.c_int, ct.c_char_p, ct.c_size_t, ct.c_ssize_t,
        ct.c_int]
    lib.rav1e_send_frame.argtypes = [ct.c_void_p, ct.c_void_p]
    lib.rav1e_receive_packet.argtypes = [
        ct.c_void_p, ct.POINTER(ct.POINTER(_RaPacket))]
    for f in ("rav1e_packet_unref", "rav1e_frame_unref",
              "rav1e_context_unref", "rav1e_config_unref"):
        getattr(lib, f).argtypes = [ct.c_void_p]
    lib.rav1e_version_full.restype = ct.c_char_p
    return lib


def _frames(w=96, h=64, n=4):
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, (h + 8, w + 8), dtype=np.uint8)
    return [[base[t:t + h, t:t + w].copy(),
             np.full((h // 2, w // 2), 100 + t, np.uint8),
             np.full((h // 2, w // 2), 140 - t, np.uint8)] for t in range(n)]


def _encode_capi(lib, frames, kv):
    cfg = lib.rav1e_config_default()
    for k, v in kv.items():
        assert lib.rav1e_config_parse(cfg, k.encode(), str(v).encode()) == 0
    ctx = lib.rav1e_context_new(cfg)
    assert ctx, "rav1e_context_new failed"
    for f in frames:
        fr = lib.rav1e_frame_new(ctx)
        for i, p in enumerate(f):
            data = np.ascontiguousarray(p).tobytes()
            lib.rav1e_frame_fill_plane(fr, i, data, len(data), p.shape[1], 1)
        assert lib.rav1e_send_frame(ctx, fr) == 0
        lib.rav1e_frame_unref(fr)
    lib.rav1e_send_frame(ctx, None)          # flush
    pkts = []
    while True:
        pp = ct.POINTER(_RaPacket)()
        st = lib.rav1e_receive_packet(ctx, ct.byref(pp))
        if st == 0 and pp:
            pkts.append((ct.string_at(pp.contents.data, pp.contents.len),
                         pp.contents.input_frameno))
            lib.rav1e_packet_unref(pp)
        elif st in (1, 3):                   # NEED_MORE_DATA, LIMIT_REACHED
            break
        else:
            raise AssertionError(f"receive_packet status {st}")
    lib.rav1e_context_unref(ctx)
    lib.rav1e_config_unref(cfg)
    return pkts


_C_ENCODER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "rav1e.h"

int main(int argc, char **argv) {
  const int W = 64, H = 64, N = 3;
  RaConfig *cfg = rav1e_config_default();
  rav1e_config_parse_int(cfg, "width", W);
  rav1e_config_parse_int(cfg, "height", H);
  rav1e_config_parse_int(cfg, "quantizer", 120);
  rav1e_config_parse_int(cfg, "speed", 10);
  rav1e_config_parse_int(cfg, "low_latency", 1);
  rav1e_config_parse(cfg, "device", "cpu");
  RaContext *ctx = rav1e_context_new(cfg);
  if (!ctx) { fprintf(stderr, "ctx fail\n"); return 2; }
  uint8_t *y = malloc(W * H), *u = malloc(W * H / 4), *v = malloc(W * H / 4);
  FILE *out = fopen(argv[1], "wb");
  for (int t = 0; t < N; t++) {
    for (int i = 0; i < W * H; i++) y[i] = (uint8_t)(i + 37 * t);
    memset(u, 100, W * H / 4);
    memset(v, 140, W * H / 4);
    RaFrame *f = rav1e_frame_new(ctx);
    rav1e_frame_fill_plane(f, 0, y, W * H, W, 1);
    rav1e_frame_fill_plane(f, 1, u, W * H / 4, W / 2, 1);
    rav1e_frame_fill_plane(f, 2, v, W * H / 4, W / 2, 1);
    if (rav1e_send_frame(ctx, f) != 0) return 3;
    rav1e_frame_unref(f);
  }
  rav1e_send_frame(ctx, NULL);
  int got = 0;
  for (;;) {
    RaPacket *p = NULL;
    RaEncoderStatus st = rav1e_receive_packet(ctx, &p);
    if (st == RA_ENCODER_STATUS_SUCCESS && p) {
      uint32_t len = (uint32_t)p->len;
      fwrite(&len, 4, 1, out);
      fwrite(p->data, 1, p->len, out);
      got++;
      rav1e_packet_unref(p);
    } else if (st == RA_ENCODER_STATUS_LIMIT_REACHED ||
               st == RA_ENCODER_STATUS_NEED_MORE_DATA) {
      break;
    } else {
      fprintf(stderr, "status %d\n", st);
      return 4;
    }
  }
  fclose(out);
  rav1e_context_unref(ctx);
  rav1e_config_unref(cfg);
  printf("packets=%d\n", got);
  return got == N ? 0 : 5;
}
"""


def test_capi_matches_context_and_embeds(tmp_path):
    """The shim (g++ against this Python) driven through ctypes with
    device=cpu gives the port Context's packets and frame numbers, and
    the stream decodes on libdav1d; without the device key it asks for
    cuda, so rav1e_context_new returns NULL where CUDA is absent. A
    standalone C program linked against the shim boots its own
    interpreter and encodes 3 frames that decode."""
    so = build()
    lib = _capi(so)
    assert b"PyTorch/CUDA" in lib.rav1e_version_full()
    w, h = 96, 64
    frames = _frames(w, h)
    kv = {"width": w, "height": h, "quantizer": 110, "speed": 10}
    pkts_c = _encode_capi(lib, frames, dict(kv, device="cpu"))
    ctx = Config.parse(kv).new_context(device="cpu")
    for f in frames:
        ctx.send_frame(f)
    ctx.flush()
    pkts_py = []
    while True:
        _, p = ctx.receive_packet()
        if p is None:
            break
        pkts_py.append((p.data, p.input_frameno))
    assert pkts_c == pkts_py
    assert len(dav1d.decode_all([d for d, _ in pkts_c])) == len(frames)
    if not torch.cuda.is_available():
        cfg = lib.rav1e_config_default()
        lib.rav1e_config_parse_int(cfg, b"width", w)
        lib.rav1e_config_parse_int(cfg, b"height", h)
        assert not lib.rav1e_context_new(cfg)
        lib.rav1e_config_unref(cfg)

    src = tmp_path / "encode.c"
    src.write_text(_C_ENCODER)
    exe = tmp_path / "encode"
    subprocess.check_call(
        ["gcc", "-O1", "-o", str(exe), str(src), f"-I{so.parent}", str(so),
         f"-Wl,-rpath,{so.parent}"])
    outfile = tmp_path / "pkts.bin"
    r = subprocess.run([str(exe), str(outfile)], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu",
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout, r.stderr)
    blob = outfile.read_bytes()
    pkts, off = [], 0
    while off < len(blob):
        ln = int.from_bytes(blob[off:off + 4], "little")
        pkts.append(blob[off + 4:off + 4 + ln])
        off += 4 + ln
    assert len(dav1d.decode_all(pkts)) == 3


def test_host_modules_match_reference():
    """quality.py (PSNR, SSIM, BD-rate), parse.py (OBUs, sequence and
    keyframe headers, the msac decoder) and rav1e_ref.py (the system
    librav1e through ctypes) give the JAX package's results on the same
    inputs."""
    rng = np.random.default_rng(4)
    a = [rng.integers(0, 256, s).astype(np.uint8)
         for s in ((64, 96), (32, 48), (32, 48))]
    b = [np.clip(p.astype(np.int32) + rng.integers(-6, 7, p.shape), 0,
                 255).astype(np.uint8) for p in a]
    assert tq.frame_psnr(a, b) == jq.frame_psnr(a, b)
    assert tq.seq_psnr([a, b], [b, a]) == jq.seq_psnr([a, b], [b, a])
    assert tq.ssim_plane(a[0], b[0]) == jq.ssim_plane(a[0], b[0])
    rates = ([100, 200, 400, 800], [30.1, 33.0, 36.2, 39.0],
             [95, 190, 390, 760], [30.0, 33.1, 36.1, 39.2])
    assert tq.bd_rate(*rates) == jq.bd_rate(*rates)

    frames = _frames(64, 64, n=3)
    pkts = tref.encode_frames(frames, speed=10, quantizer=120)
    assert pkts == jref.encode_frames(frames, speed=10, quantizer=120)
    # rav1e's stream for the OBU walk and sequence header, the port's own
    # keyframe for the frame header and the tile's symbols (parse.py reads
    # the keyframe subset this encoder writes)
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    kpkt, _ = encode_keyframe_tpu(frames[0], 100, speed=10, device="cpu")
    for pkt in pkts + [kpkt]:
        assert [(t, bytes(b)) for t, b in tparse.parse_obus(pkt)] == \
            [(t, bytes(b)) for t, b in jparse.parse_obus(pkt)]
    seq = [b for t, b in tparse.parse_obus(pkts[0]) if t == 1][0]
    assert tparse.parse_sequence_header(seq).__dict__ == \
        jparse.parse_sequence_header(seq).__dict__
    obus = list(tparse.parse_obus(kpkt))
    seq = [b for t, b in obus if t == 1][0]
    frame = [b for t, b in obus if t == 6][0]
    st, sj = (tparse.parse_sequence_header(seq),
              jparse.parse_sequence_header(seq))
    ft, fj = (tparse.parse_intra_frame(frame, st),
              jparse.parse_intra_frame(frame, sj))
    assert ft.__dict__ == fj.__dict__
    tile = frame[ft.tile_data_offset:]
    mt, mj = tparse.Msac(tile), jparse.Msac(tile)
    cdf = [16384, 0, 0]
    assert [mt.decode_symbol(list(cdf)) for _ in range(64)] == \
        [mj.decode_symbol(list(cdf)) for _ in range(64)]
    assert [mt.decode_bool(128 << 7) for _ in range(64)] == \
        [mj.decode_bool(128 << 7) for _ in range(64)]
