#!/usr/bin/env python
"""Profile the native encoder on N 1080p all-intra frames.

Prints per-counter cycle totals from the native core's g_prof[] slots.
Counter map (see PROF_BEGIN sites in codec_core.cpp):
  1  sweep: angular prediction        2  sweep: SATD (calc_had)
  3  sweep: mode-bits classes         4  luma RQT RD (es_recur_intra_luma)
  5  RDOQ                             6  chroma search total
  7  es_encode_cu_final               8  (see source)
  9  (see source)                    10  bits_qt
 11  (see source)                    12  final transform tree
 13  ADI fill                        14  (see source)
 15  final intra luma pass           16  (see source)
 18  inter 2Nx2N  19 merge  20 rect  21  es_check_intra total
 22/23 (see source)

Usage: env PYTHONPATH= JAX_PLATFORMS=cpu python tools/profile_encode.py [frames]
"""
import ctypes
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("THEVC_DEVICE", "0")
os.environ.setdefault("THEVC_DEVICE_ENC", "0")

frames = int(sys.argv[1]) if len(sys.argv) > 1 else 2
fastrd = "--fastrd" in sys.argv
clip = os.path.join(REPO, "testdata", "bench_1080p_4f.yuv")
if not os.path.exists(clip):
    clip = os.path.join(REPO, "testdata", "bench_1080p.yuv")

from thevc.native import get_lib  # noqa: E402
from thevc.apps.encoder import main as enc_main  # noqa: E402
from thevc.utils.cfg import CFG_DIR  # noqa: E402

lib = get_lib()
# drain counters
buf = (ctypes.c_uint64 * 32)()
lib.get_prof(ctypes.cast(buf, ctypes.c_void_p))

out = os.path.join("/tmp", "prof_enc.bin")
t0 = time.time()
c0 = time.process_time()     # excludes hypervisor steal, unlike rdtsc/wall
enc_main([
    "-c", f"{CFG_DIR}/encoder_intra_main.cfg",
    "-i", clip, "-wdt", "1920", "-hgt", "1080",
    "-f", str(frames), "-fr", "30", "-b", out,
    "-o", "/dev/null", "--SEIpictureDigest=1",
] + (["--FastRD=1"] if fastrd else []))
dt = time.time() - t0
dc = time.process_time() - c0

lib.get_prof(ctypes.cast(buf, ctypes.c_void_p))
total_cyc = 2.1e9 * dt
print(f"\nwall {dt:.2f}s cpu {dc:.2f}s for {frames} frames "
      f"({dc/frames:.2f} cpu-s/frame)")
names = {1: "sweep:pred", 2: "sweep:SATD", 3: "sweep:modebits",
         4: "luma RQT RD", 5: "RDOQ", 6: "chroma total", 7: "cu_final",
         8: "p8", 9: "p9", 10: "bits_qt", 11: "p11", 12: "final_tt",
         13: "ADI", 14: "p14", 15: "final_luma", 16: "p16",
         18: "inter2Nx2N", 19: "merge", 20: "rect", 21: "check_intra",
         22: "p22", 23: "p23"}
rows = [(i, buf[i]) for i in range(32) if buf[i]]
rows.sort(key=lambda r: -r[1])
for i, v in rows:
    print(f"prof{i:2d} {names.get(i, '?'):14s} {v/1e9:8.2f} Gcyc  "
          f"{100.0*v/total_cyc:5.1f}%")
