#!/usr/bin/env python
"""Run the codec's main path once on a GPU, end to end, and check it.

    python chip_smoke.py               # one card: phases 0-5 below
    python chip_smoke.py --four-cards  # the multi-card path only (4 GPUs)

One process holds the card(s) for the whole run.  The phases run in
order and the first failure ends the run with a non-zero exit code:

  0  device: a GPU is required; prints the card and the compile cache
  1  native core: builds codec_core for this host and loads it
  2  parity at one 1080p frame's widths, bit-exact against the numpy
     reference: residual core, forward/inverse transform, fast-RD SATD;
     then the tests marked `gpu` (tests/test_gpu.py)
  3  all-intra 1080p, 8 frames: fast-RD encode through the encoder CLI
     with the decision pass on the GPU, then the device decode (AUTO);
     every digest (OK) and decoder output == encoder recon
  4  random-access 1080p, 9 frames: the same checks (device motion
     search in the encoder, per-picture device MC in the decoder)
  5  device apply (THEVC_FASTRD_DEVAPPLY=1): one 1080p all-intra frame

--four-cards runs only the multi-device path: one seeded 1080p all-intra
fast-RD stream per card, 2 frames each, every frame's QP drawn from the
shared rate-control pool whose psum runs over a 4-GPU mesh; each stream
decoded on its own card and again on card 0 (byte-identical, every
digest (OK)); and each stream's launches proven to have run on its card.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PLATFORM = "gpu"      # where every device launch must land
W, H = 1920, 1080


def frame_tus() -> dict:
    """TUs per size class that cover one W x H 4:2:0 frame (luma +
    chroma): the batch one size class's launch takes at most."""
    return {s: (W * H * 3 // 2) // (s * s) for s in (4, 8, 16, 32)}


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def timed(fn, *args, reps=5):
    """Median wall time of fn(*args) in ms, after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phase 0 and 1
# ---------------------------------------------------------------------------

def phase_device(n_cards: int):
    import jax
    backend = jax.default_backend()
    check(backend == "gpu", f"JAX found no GPU (default backend {backend!r})")
    devs = jax.devices()
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    log(f"platform={devs[0].platform} device_kind={devs[0].device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    from thevc.ops import device
    device.enable_compile_cache()
    log(f"compile cache: {device.compile_cache_dir()}")
    return devs


def phase_native():
    from thevc import native
    t0 = time.perf_counter()
    lib = native.get_lib()
    check(lib is not None, f"native core unavailable: {native.build_error()}")
    log(f"native core: {native.lib_path().name} "
        f"({time.perf_counter() - t0:.1f} s to build and load)")


# ---------------------------------------------------------------------------
# phase 2: parity at real widths
# ---------------------------------------------------------------------------

def phase_parity():
    import jax.numpy as jnp
    from thevc.encoder.fast_intra import _satd
    from thevc.encoder.rdcost import calc_had_batched
    from thevc.ops import jx
    from thevc.ops import transforms as tops

    rng = np.random.RandomState(2024)
    for s, n in frame_tus().items():
        for use_dst, bi in ((False, 0), (True, 0), (False, 2)):
            if use_dst and s != 4:
                continue
            q = rng.randint(-32768, 32768, (n, s, s)).astype(np.int16)
            qp = rng.randint(0, 52 + 6 * bi, n).astype(np.int32)
            ref = tops.inverse_transform(
                tops.dequant(q.astype(np.int32), qp, bi), use_dst,
                bi).astype(np.int16)
            qd, qpd = jnp.asarray(q), jnp.asarray(qp)
            got = np.asarray(jx.residual_pipeline(qd, qpd, use_dst, bi))
            check(np.array_equal(got, ref),
                  f"residual core {s}x{s} dst={use_dst} bi={bi} differs")
            ms = timed(jx.residual_pipeline, qd, qpd, use_dst, bi)
            log(f"residual core {s:2d}x{s:<2d} dst={int(use_dst)} bi={bi} "
                f"N={n}: bit-exact, {ms:.3f} ms")

            resi = rng.randint(-(256 << bi) + 1, 256 << bi,
                               (n, s, s)).astype(np.int32)
            ref = tops.forward_transform(resi, use_dst, bi)
            got = np.asarray(jx.forward_transform(resi, use_dst, bi))
            check(np.array_equal(got, ref),
                  f"forward_transform {s}x{s} dst={use_dst} bi={bi} differs")
            coeff = rng.randint(-32768, 32768, (n, s, s)).astype(np.int32)
            ref = tops.inverse_transform(coeff, use_dst, bi)
            got = np.asarray(jx.inverse_transform(coeff, use_dst, bi))
            check(np.array_equal(got, ref),
                  f"inverse_transform {s}x{s} dst={use_dst} bi={bi} differs")
            log(f"forward/inverse transform {s:2d}x{s:<2d} dst={int(use_dst)}"
                f" bi={bi} N={n}: bit-exact")

    # fast-RD SATD: one 1080p frame's blocks per size class, one original
    # against a batch of candidate predictions (the mode sweep's shape)
    for s in (4, 8, 16, 32, 64):
        n = (W * (-(-H // 64) * 64)) // (s * s)
        for bi in (0, 2):
            hi = 256 << bi
            org = rng.randint(0, hi, (s, s)).astype(np.int32)
            preds = rng.randint(0, hi, (n, s, s)).astype(np.int32)
            ref = calc_had_batched(org, preds, bi)
            got = np.asarray(_satd(jnp.broadcast_to(jnp.asarray(org),
                                                    preds.shape),
                                   jnp.asarray(preds), s, bi))
            check(np.array_equal(got, ref),
                  f"fast-RD SATD {s}x{s} bi={bi} differs")
        log(f"fast-RD SATD {s:2d}x{s:<2d} N={n}: bit-exact")


def run_gpu_tests():
    """The tests marked `gpu` (they skip on CPU hosts), in this process."""
    env = dict(os.environ)
    try:
        import pytest
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                          str(REPO / "tests" / "test_gpu.py")])
    finally:
        os.environ.clear()
        os.environ.update(env)
    check(rc == 0, f"tests marked gpu failed (pytest exit {rc})")


# ---------------------------------------------------------------------------
# phases 3-5: encode + decode through the CLIs
# ---------------------------------------------------------------------------

def make_clip(path: Path, frames: int, seed: int) -> None:
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(W), "--height", str(H),
                    "--frames", str(frames), "--seed", str(seed)],
                   check=True, capture_output=True)


def encode_decode(td: Path, name: str, cfg: str, frames: int, seed: int,
                  extra=()):
    """Encode a seeded 1080p clip with fast-RD through the encoder CLI,
    decode it through the decoder CLI, and check digests and recon."""
    from thevc.apps.decoder import main as decoder_main
    from thevc.apps.encoder import main as encoder_main
    from thevc.ops import device
    from thevc.utils.cfg import CFG_DIR

    clip, bits = td / f"{name}.yuv", td / f"{name}.bin"
    rec, dec = td / f"{name}_rec.yuv", td / f"{name}_dec.yuv"
    make_clip(clip, frames, seed)

    device.stats_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = encoder_main(["-c", str(CFG_DIR / cfg), "-i", str(clip),
                           "-wdt", str(W), "-hgt", str(H), "-f", str(frames),
                           "-fr", "30", "-b", str(bits), "-o", str(rec),
                           "--FastRD=1", "--SEIpictureDigest=1", *extra])
    t_enc = time.perf_counter() - t0
    check(rc == 0, f"{name}: encoder exit {rc}")
    enc_stats = dict(device.STATS)
    platforms = {d.platform for d in device.LAUNCH_DEVICES}
    check(enc_stats["launches"] > 0, f"{name}: no device launch in encode")
    check(platforms == {PLATFORM},
          f"{name}: encoder device launches ran on {platforms}")
    log(f"{name}: encoded {frames} frames in {t_enc:.1f} s "
        f"(cold, compilation included), {enc_stats['launches']} device "
        f"launches on {sorted(platforms)}, {bits.stat().st_size} bytes")

    device.stats_reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = decoder_main(["-b", str(bits), "-o", str(dec)])
    t_dec = time.perf_counter() - t0
    check(rc == 0, f"{name}: decoder exit {rc}")
    n_ok = buf.getvalue().count("(OK)")
    check(n_ok == frames, f"{name}: {n_ok} of {frames} digests (OK)")
    check(dec.read_bytes() == rec.read_bytes(),
          f"{name}: decoder output differs from encoder recon")
    platforms = {d.platform for d in device.LAUNCH_DEVICES}
    check(device.STATS["launches"] > 0 and platforms == {PLATFORM},
          f"{name}: decode launches {device.STATS['launches']} on "
          f"{platforms}")
    log(f"{name}: decoded {frames} frames in {t_dec:.1f} s "
        f"(cold), {device.STATS['launches']} device launches on "
        f"{PLATFORM}, "
        f"{n_ok} digests (OK), decoder output == encoder recon")
    return bits


def phase_devapply(td: Path):
    from thevc.encoder import fast_apply
    os.environ["THEVC_FASTRD_DEVAPPLY"] = "1"
    try:
        fast_apply.stats_reset()
        encode_decode(td, "devapply_1080p", "encoder_intra_main.cfg", 1, 3)
        st = fast_apply.stats_reset()
    finally:
        os.environ.pop("THEVC_FASTRD_DEVAPPLY", None)
    check(st["frames"] == 1, f"device apply ran on {st['frames']} frames")
    log("device apply: 1 frame applied on the GPU, conformant")


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------

def four_cards(devs):
    import jax
    from __graft_entry__ import dryrun_multichip
    from thevc.decoder.top import Decoder
    from thevc.ops import device

    t0 = time.perf_counter()
    slots = dryrun_multichip(4, W, H, n_frames=2)
    log(f"4 streams encoded and decoded, one per card, shared rate pool "
        f"psum over the 4-GPU mesh: {time.perf_counter() - t0:.1f} s")
    for i, slot in enumerate(slots):
        check(slot["enc_devices"] == {devs[i]},
              f"stream {i}: encode launches on {slot['enc_devices']}")
        check(slot["dec_devices"] == {devs[i]},
              f"stream {i}: decode launches on {slot['dec_devices']}")
        device.LAUNCH_DEVICES.clear()
        os.environ["THEVC_DEVICE"] = "1"
        try:
            with jax.default_device(devs[0]):
                ref = Decoder().decode_stream(slot["stream"])
        finally:
            os.environ.pop("THEVC_DEVICE", None)
        check(all(p.digest_ok is True for p in ref),
              f"stream {i}: card-0 decode digest mismatch")
        check(len(ref) == len(slot["pictures"]), f"stream {i}: frame count")
        for a, b in zip(slot["pictures"], ref):
            fa, fb = a.frame, b.frame
            check(all(np.array_equal(x, y) for x, y in
                      ((fa.y, fb.y), (fa.cb, fb.cb), (fa.cr, fb.cr))),
                  f"stream {i} poc {a.poc}: card {i} and card 0 differ")
        log(f"stream {i}: {len(slot['stream'])} bytes, encode and decode on "
            f"{devs[i]}, decode on card 0 byte-identical, "
            f"{len(ref)} digests (OK)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path on 4 GPUs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    t_start = time.perf_counter()
    try:
        devs = phase_device(n_cards)
        phase_native()
        if args.four_cards:
            four_cards(devs)
        else:
            os.environ.pop("THEVC_DEVICE", None)          # AUTO
            t = time.perf_counter()
            phase_parity()
            run_gpu_tests()
            log(f"phase 2 done in {time.perf_counter() - t:.1f} s")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
                td = Path(d)
                t = time.perf_counter()
                encode_decode(td, "allintra_1080p",
                              "encoder_intra_main.cfg", 8, 1)
                log(f"phase 3 done in {time.perf_counter() - t:.1f} s")
                t = time.perf_counter()
                encode_decode(td, "randomaccess_1080p",
                              "encoder_randomaccess_main.cfg", 9, 2)
                log(f"phase 4 done in {time.perf_counter() - t:.1f} s")
                t = time.perf_counter()
                phase_devapply(td)
                log(f"phase 5 done in {time.perf_counter() - t:.1f} s")
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
