#!/usr/bin/env python
"""Interleaved A/B benchmark of two prebuilt codec_core.so variants.

The bench host's CPU frequency drifts minute-to-minute (hypervisor), so
single timings are worthless.  This alternates A and B .so files run-by-
run (ABBA order per round to cancel linear drift) and reports per-variant
process-CPU times and the pairwise ratio.

Usage: python tools/ab_bench.py A.so B.so [rounds] [frames]
"""
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfg", "encoder_intra_main.cfg")

a_so, b_so = sys.argv[1], sys.argv[2]
rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 3
frames = sys.argv[4] if len(sys.argv) > 4 else "2"

CODE = r"""
import os, sys, time
sys.path.insert(0, %r)
os.environ["THEVC_DEVICE"] = "0"
from thevc.apps.encoder import main as enc_main
clip = os.path.join(%r, "testdata", "bench_1080p_4f.yuv")
argv = ["-c", %r, "-i", clip, "-wdt", "1920", "-hgt", "1080",
        "-f", %r, "-fr", "30", "-b", os.devnull,
        "-o", os.devnull, "--SEIpictureDigest=1"]
enc_main(argv)
c0 = time.process_time(); t0 = time.time()
enc_main(argv)
print("CPUS %%.3f WALL %%.3f" %% (time.process_time() - c0, time.time() - t0))
""" % (REPO, REPO, CFG, frames)


def run_one(so):
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu",
               THEVC_NATIVE_LIB=os.path.abspath(so))
    out = subprocess.run([sys.executable, "-c", CODE], env=env,
                         capture_output=True, text=True, timeout=900)
    for ln in out.stdout.splitlines():
        if ln.startswith("CPUS"):
            return float(ln.split()[1])
    print(out.stdout[-2000:], out.stderr[-2000:])
    raise RuntimeError("no timing line")


res = {"A": [], "B": []}
for r in range(rounds):
    order = ["A", "B", "B", "A"] if r % 2 == 0 else ["B", "A", "A", "B"]
    for tag in order:
        t = run_one(a_so if tag == "A" else b_so)
        res[tag].append(t)
        print(f"round {r} {tag}: {t:.3f} cpu-s", flush=True)

ma, mb = statistics.median(res["A"]), statistics.median(res["B"])
print(f"A median {ma:.3f}  B median {mb:.3f}  B/A {mb/ma:.4f}")
print(f"A min {min(res['A']):.3f}  B min {min(res['B']):.3f}  "
      f"minB/minA {min(res['B'])/min(res['A']):.4f}")
