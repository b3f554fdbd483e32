#!/usr/bin/env python
"""Measure fast-RD quality vs the HM-exact encoder: bits and PSNR at equal
QP over a QP sweep.  Usage: python tools/fastrd_quality.py [clip] [w] [h] [f]
"""
import os
import re
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from thevc.utils.cfg import CFG_DIR  # noqa: E402

clip = sys.argv[1] if len(sys.argv) > 1 else "testdata/clip_416x240.yuv"
w = sys.argv[2] if len(sys.argv) > 2 else "416"
h = sys.argv[3] if len(sys.argv) > 3 else "240"
f = sys.argv[4] if len(sys.argv) > 4 else "2"

ORACLE = os.path.join(REPO, ".oracle", "bin", "TAppEncoder")


def run_ours(qp, fast):
    from thevc.apps.encoder import main as enc_main
    import io
    import contextlib
    out = f"/tmp/frq_{qp}_{fast}.bin"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        enc_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", clip, "-wdt", w, "-hgt", h, "-f", f, "-fr", "30",
                  "-q", str(qp), "-b", out, "-o", "/dev/null",
                  "--SEIpictureDigest=1", f"--FastRD={int(fast)}"])
    return parse(buf.getvalue()), os.path.getsize(out)


def run_hm(qp):
    out = f"/tmp/frq_{qp}_hm.bin"
    r = subprocess.run(
        [ORACLE, "-c", f"{CFG_DIR}/encoder_intra_main.cfg",
         "-i", clip, "-wdt", w, "-hgt", h, "-f", f, "-fr", "30",
         "-q", str(qp), "-b", out, "-o", "/dev/null",
         "--SEIpictureDigest=1"],
        capture_output=True, text=True, check=True)
    return parse(r.stdout), os.path.getsize(out)


def parse(txt):
    bits = 0
    psnr = []
    for m in re.finditer(r"(\d+) bits \[Y ([\d.]+) dB", txt):
        bits += int(m.group(1))
        psnr.append(float(m.group(2)))
    return bits, sum(psnr) / len(psnr)


for qp in (22, 27, 32, 37):
    (hb, hp), hsz = run_hm(qp)
    (fb, fp), fsz = run_ours(qp, True)
    print(f"QP{qp}: HM {hb}b Y{hp:.3f}dB | fast {fb}b Y{fp:.3f}dB | "
          f"bits {100.0*(fb-hb)/hb:+.2f}% dPSNR {fp-hp:+.3f}dB")
