"""CLI: y4m in -> AV1 IVF out (reference parity: rav1e src/bin/rav1e.rs).

Usage: python -m rav1e_tpu_torch.cli.main input.y4m -o output.ivf
           [--quantizer Q] [--speed S] [--limit N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

from rav1e_tpu_torch.api import Config, EncoderStatus
from rav1e_tpu_torch.cli.ivf import ivf_frame, ivf_header
from rav1e_tpu_torch.cli.y4m import Y4MReader


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rav1e_tpu_torch")
    ap.add_argument("input", help="y4m input file (or - for stdin)")
    ap.add_argument("-o", "--output", required=True, help="IVF output")
    ap.add_argument("--quantizer", type=int, default=100)
    ap.add_argument("--speed", type=int, default=6)
    ap.add_argument("--limit", type=int, default=0, help="max frames")
    ap.add_argument("--bitrate", type=int, default=0,
                    help="target bits/sec (0 = constant quality)")
    ap.add_argument("--keyint", type=int, default=240,
                    help="max keyframe interval")
    ap.add_argument("--tiles", type=int, default=1,
                    help="tile count (rounded to a power of two)")
    ap.add_argument("--no-cdef", action="store_true")
    ap.add_argument("--photon-noise", type=int, default=0,
                    help="ISO-style film grain strength (0 = off)")
    ap.add_argument("--first-pass", default="",
                    help="write two-pass stats to FILE (pass 1)")
    ap.add_argument("--second-pass", default="",
                    help="read two-pass stats from FILE (pass 2)")
    ap.add_argument("--low-latency",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="disable B-frame reordering (rav1e default: "
                         "reordered GOPs, matching api.Config)")
    ap.add_argument("--tune", default="Psnr",
                    choices=["Psnr", "Psychovisual"])
    ap.add_argument("--content-light", default="",
                    help="HDR CLL metadata: MaxCLL,MaxFALL (nits)")
    ap.add_argument("--mastering-display", default="",
                    help="HDR MDCV metadata: rx,ry,gx,gy,bx,by,wx,wy,"
                         "max_nits,min_nits")
    ap.add_argument("--color-description", default="",
                    help="primaries,transfer,matrix (spec code points)")
    ap.add_argument("-s", "--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="raw config key (rav1e_config_parse analog)")
    ap.add_argument("--device", default="cuda",
                    help="torch device that codes every frame (cpu runs "
                         "the port on the CPU)")
    args = ap.parse_args(argv)

    src = sys.stdin.buffer if args.input == "-" else args.input
    rd = Y4MReader(src)
    info = rd.info
    extra = {}
    if args.bitrate:
        extra["bitrate"] = args.bitrate
        extra["framerate"] = info.fps_num / max(info.fps_den, 1)
    if args.no_cdef:
        extra["cdef"] = "off"
    if args.photon_noise:
        extra["photon_noise"] = args.photon_noise
    if args.first_pass:
        extra["pass"] = 1
    elif args.second_pass:
        extra["pass"] = 2
    if args.tune != "Psnr":
        extra["tune"] = args.tune
    if args.content_light:
        extra["content_light"] = args.content_light
    if args.mastering_display:
        extra["mastering_display"] = args.mastering_display
    if args.color_description:
        extra["color_description"] = args.color_description
    for kv in args.set:
        k, _, v = kv.partition("=")
        extra[k.strip()] = v.strip()
    cfg = Config(width=info.width, height=info.height,
                 quantizer=args.quantizer, speed=args.speed,
                 key_frame_interval=args.keyint, tiles=args.tiles,
                 bit_depth=info.bit_depth,
                 chroma_sampling=info.chroma,
                 low_latency=args.low_latency,
                 extra=extra)
    # raw keys may target Config fields too (rav1e_config_parse)
    known = {k: v for k, v in extra.items() if hasattr(cfg, k)}
    if known:
        for k, v in known.items():
            del cfg.extra[k]
        patched = Config.parse({**known})
        for k in known:
            setattr(cfg, k, getattr(patched, k))
    ctx = cfg.new_context(device=args.device)
    if args.second_pass:
        with open(args.second_pass, "rb") as f:
            ctx.twopass_in(f.read())
    t0 = time.time()
    n_in = n_out = total = 0
    with open(args.output, "wb") as out:
        out.write(ivf_header(info.width, info.height,
                             info.fps_num, info.fps_den))
        for frame in rd:
            ctx.send_frame([p for p in frame])
            n_in += 1
            while True:
                st, pkt = ctx.receive_packet()
                if st != EncoderStatus.SUCCESS:
                    break
                out.write(ivf_frame(pkt.data, pkt.input_frameno))
                n_out += 1
                total += len(pkt.data)
            if args.limit and n_in >= args.limit:
                break
        ctx.flush()
        while True:
            st, pkt = ctx.receive_packet()
            if st != EncoderStatus.SUCCESS:
                break
            out.write(ivf_frame(pkt.data, pkt.input_frameno))
            n_out += 1
            total += len(pkt.data)
    dt = time.time() - t0
    if args.first_pass:
        with open(args.first_pass, "wb") as f:
            f.write(ctx.twopass_out())
            f.write(ctx.twopass_summary())
    print(f"encoded {n_out} frames, {total} bytes, "
          f"{n_out / dt:.3f} fps", file=sys.stderr)


if __name__ == "__main__":
    main()
