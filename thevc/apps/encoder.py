"""Encoder CLI: python -m thevc.apps.encoder -c encoder_intra_main.cfg \
   -i in.yuv -b str.bin -o rec.yuv -wdt W -hgt H -f N -fr FPS

Behavioral reference: TAppEncoder/encmain.cpp + TAppEncTop.cpp.
"""

from __future__ import annotations

import sys

from ..encoder.top import Encoder
from ..utils.cfg import parse_args


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg = parse_args(argv)
    if not cfg.input_file or not cfg.bitstream_file:
        print("usage: encoder -c cfg [-i in.yuv -b out.bin -o rec.yuv "
              "-wdt W -hgt H -f N -fr FPS]", file=sys.stderr)
        return 1
    enc = Encoder(cfg)
    enc.encode(cfg.bitstream_file)
    enc.print_summary()
    # TAppEncTop::printRateSummary (TAppEncTop.cpp:486-493)
    n = max(enc.frames_encoded, 1)
    fr = cfg.frame_rate or 30
    total_bytes = enc.total_bits // 8
    print("Bytes written to file: %u (%.3f kbps)"
          % (total_bytes, 0.008 * total_bytes / (n / fr)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
