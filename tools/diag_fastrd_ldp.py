#!/usr/bin/env python
"""Diagnose fast-RD LDP overhead: encode exact vs FastRD=1, then decode
both streams and compare decision statistics (depth histogram, pred mode,
skip/merge share, bits per frame)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("THEVC_DEVICE", "0")

import numpy as np

from thevc.utils.cfg import CFG_DIR, parse_args
from thevc.encoder.top import Encoder
from thevc.decoder.top import Decoder

CLIP = sys.argv[1] if len(sys.argv) > 1 else "testdata/clip_416x240.yuv"
W = int(sys.argv[2]) if len(sys.argv) > 2 else 416
H = int(sys.argv[3]) if len(sys.argv) > 3 else 240
F = int(sys.argv[4]) if len(sys.argv) > 4 else 5
QP = int(sys.argv[5]) if len(sys.argv) > 5 else 32


def enc(fast):
    argv = ["-c", f"{CFG_DIR}/encoder_lowdelay_P_main.cfg",
            "-i", CLIP, "-wdt", str(W), "-hgt", str(H),
            "-f", str(F), "-fr", "30", "-q", str(QP), "-b", "/dev/null",
            "-o", "/dev/null", "--SEIpictureDigest=1",
            f"--FastRD={int(fast)}"]
    cfg = parse_args(argv)
    e = Encoder(cfg)
    e.verbose = False
    t0 = time.time()
    s = e.encode(None)
    return s, time.time() - t0


def stats(stream):
    dec = Decoder()
    dec.keep_models = True
    pics = dec.decode_stream(stream)
    assert all(p.digest_ok for p in pics)
    rows = []
    for p in sorted(pics, key=lambda q: q.poc):
        f = p.model
        if f is None:
            continue
        uw, uh = (W + 63) // 64 * 16, (H + 63) // 64 * 16
        val = np.zeros((uh, uw), bool)
        val[:H // 4, :W // 4] = True
        depth = np.asarray(f.depth)[val]
        pred = np.asarray(f.pred_mode)[val]   # 1 = MODE_INTRA
        skip = np.asarray(f.skip)[val]
        merge = np.asarray(f.merge_flag)[val]
        rows.append(dict(
            poc=p.poc,
            depth_hist=np.bincount(np.maximum(depth.ravel(), 0),
                                   minlength=4)[:4],
            intra_pct=100.0 * (pred.ravel() == 1).mean(),
            skip_pct=100.0 * (skip.ravel() != 0).mean(),
            merge_pct=100.0 * (merge.ravel() != 0).mean(),
        ))
    return rows


import hashlib
tag = hashlib.md5(f"{CLIP}{W}{H}{F}{QP}".encode()).hexdigest()[:8]
pe, pf = f"/tmp/diag_{tag}_exact.bin", f"/tmp/diag_{tag}_fast.bin"
if os.path.exists(pe) and "--fresh" not in sys.argv:
    s_exact, dt_e = open(pe, "rb").read(), 0.0
else:
    s_exact, dt_e = enc(False)
    open(pe, "wb").write(s_exact)
if os.path.exists(pf) and "--fresh" not in sys.argv:
    s_fast, dt_f = open(pf, "rb").read(), 0.0
else:
    s_fast, dt_f = enc(True)
    open(pf, "wb").write(s_fast)
print(f"exact: {len(s_exact)} bytes  {dt_e:.1f}s")
print(f"fast : {len(s_fast)} bytes  {dt_f:.1f}s  "
      f"overhead {100.0 * (len(s_fast) / len(s_exact) - 1):.1f}%")

# per-frame bit split via NAL sizes
from thevc.nal import iter_annexb_nals
for name, s in (("exact", s_exact), ("fast", s_fast)):
    sizes = [(n.nal_type, len(n.rbsp)) for n in iter_annexb_nals(s)]
    print(name, "NAL sizes:", sizes)

for name, s in (("exact", s_exact), ("fast", s_fast)):
    print(f"--- {name} ---")
    for r in stats(s):
        print(f"  poc {r['poc']}: depth {r['depth_hist']} "
              f"intra {r['intra_pct']:.1f}% skip {r['skip_pct']:.1f}% "
              f"merge {r['merge_pct']:.1f}%")
