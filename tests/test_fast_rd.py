"""Fast-RD intra encoder (encoder/fast_intra.py): conformance + quality.

FastRD=1 replaces HM's sequential RD walk with an open-loop device-batched
decision pass (TEncCu.cpp:386 becomes batched SATD/RD kernels), so streams
are NOT byte-matched to HM — the contract is instead:

  1. the stream is conformant: the HM oracle decoder reproduces our
     encoder's reconstruction (MD5 SEI checks out),
  2. our own decoder round-trips it digest-exact,
  3. quality stays close to the exact path: bit cost within a bounded
     overhead at (near-)equal PSNR.
"""

import re
import subprocess

import numpy as np
import pytest

from thevc.utils.cfg import CFG_DIR
from tests.conftest import TESTDATA, ORACLE_BIN

from thevc.apps.encoder import main as encoder_main
from thevc.apps.decoder import main as decoder_main


def _encode(clip, out, w, h, frames, qp, fast, extra=()):
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(clip), "-b", str(out),
                  "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
                  "-fr", "30", "-q", str(qp), f"--FastRD={int(fast)}",
                  "--SEIpictureDigest=1", *extra])


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float((d * d).mean())
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("qp", [27, 37])
def test_fast_rd_conformant_and_roundtrips(oracle, test_clip, tmp_path, qp):
    """HM decodes the fast-RD stream with all MD5 SEIs OK; our decoder
    round-trips it digest-exact."""
    my_bin = tmp_path / "fast.bin"
    _encode(test_clip, my_bin, 416, 240, 2, qp, fast=1)

    r = subprocess.run(
        [str(ORACLE_BIN / "TAppDecoder"), "-b", str(my_bin),
         "-o", str(tmp_path / "hm_rec.yuv")],
        capture_output=True, text=True, check=True)
    oks = re.findall(r"\((OK|\*\*ERR\*\*)\)", r.stdout)
    assert oks and all(o == "OK" for o in oks), r.stdout

    decoder_main(["-b", str(my_bin), "-o", str(tmp_path / "my_rec.yuv")])
    assert (tmp_path / "my_rec.yuv").read_bytes() == \
        (tmp_path / "hm_rec.yuv").read_bytes()


def test_fast_rd_quality_vs_exact(oracle, test_clip, tmp_path):
    """Fast-RD costs a bounded bitrate overhead at near-equal PSNR vs the
    byte-exact path at the same QP."""
    qp, w, h, frames = 32, 416, 240, 2
    exact_bin = tmp_path / "exact.bin"
    fast_bin = tmp_path / "fast.bin"
    _encode(test_clip, exact_bin, w, h, frames, qp, fast=0)
    _encode(test_clip, fast_bin, w, h, frames, qp, fast=1)

    nbytes = w * h * 3 // 2 * frames
    src = np.frombuffer(test_clip.read_bytes()[:nbytes], np.uint8)

    recs = {}
    for name, bs in (("exact", exact_bin), ("fast", fast_bin)):
        rec = tmp_path / f"{name}.yuv"
        decoder_main(["-b", str(bs), "-o", str(rec)])
        recs[name] = np.frombuffer(rec.read_bytes(), np.uint8)

    p_exact = _psnr(src, recs["exact"])
    p_fast = _psnr(src, recs["fast"])
    bits_exact = exact_bin.stat().st_size
    bits_fast = fast_bin.stat().st_size

    # measured on synthetic content: ~1-6% bit overhead, PSNR within 0.2 dB
    assert bits_fast <= bits_exact * 1.15, (bits_fast, bits_exact)
    assert p_fast >= p_exact - 0.5, (p_fast, p_exact)


def test_fast_rd_ldp_conformant_and_roundtrips(oracle, tmp_path):
    """Fast-RD for P slices (encoder/fast_inter.py): device-batched
    motion search + forced-MV apply with real merge RD.  The stream must
    decode digest-OK in the HM decoder and round-trip through ours."""
    from tests.conftest import ensure_clip
    ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    my_bin = tmp_path / "fastp.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_lowdelay_P_main.cfg",
                  "-i", "testdata/clip_96x80_9f.yuv", "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "6", "-fr", "30",
                  "-q", "32", "--FastRD=1", "--SEIpictureDigest=1"])

    r = subprocess.run(
        [str(ORACLE_BIN / "TAppDecoder"), "-b", str(my_bin),
         "-o", str(tmp_path / "hm_rec.yuv")],
        capture_output=True, text=True, check=True)
    oks = re.findall(r"\((OK|\*\*ERR\*\*)\)", r.stdout)
    assert len(oks) == 6 and all(o == "OK" for o in oks), r.stdout

    decoder_main(["-b", str(my_bin), "-o", str(tmp_path / "my_rec.yuv")])
    assert (tmp_path / "my_rec.yuv").read_bytes() == \
        (tmp_path / "hm_rec.yuv").read_bytes()


def test_fast_rd_wpp_conformant_and_roundtrips(oracle, test_clip, tmp_path):
    """Fast-RD composed with WaveFrontSynchro=1: the decision maps bind to
    the WPP-unfenced native path (slice_encoder wpp_native), substreams +
    entry points stay spec-valid — the HM decoder verifies every digest
    and our decoder round-trips the reconstruction (VERDICT r03 #5)."""
    my_bin = tmp_path / "fastwpp.bin"
    _encode(test_clip, my_bin, 416, 240, 2, 32, fast=1,
            extra=("--WaveFrontSynchro=1",))

    r = subprocess.run(
        [str(ORACLE_BIN / "TAppDecoder"), "-b", str(my_bin),
         "-o", str(tmp_path / "hm_rec.yuv")],
        capture_output=True, text=True, check=True)
    oks = re.findall(r"\((OK|\*\*ERR\*\*)\)", r.stdout)
    assert len(oks) == 2 and all(o == "OK" for o in oks), r.stdout

    decoder_main(["-b", str(my_bin), "-o", str(tmp_path / "my_rec.yuv")])
    assert (tmp_path / "my_rec.yuv").read_bytes() == \
        (tmp_path / "hm_rec.yuv").read_bytes()


def test_fast_rd_ra_conformant_and_roundtrips(oracle, tmp_path):
    """Fast-RD for B slices (random access): per-list device motion
    search + a bi-prediction stage on the uni winners (one vmapped
    search over the stacked lists), forced dir/ref/MV apply with real
    merge RD.  HM must verify every digest; our decoder round-trips."""
    from tests.conftest import ensure_clip
    ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    my_bin = tmp_path / "fastb.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
                  "-i", "testdata/clip_96x80_9f.yuv", "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "9", "-fr", "30",
                  "-q", "32", "--FastRD=1", "--SEIpictureDigest=1"])

    r = subprocess.run(
        [str(ORACLE_BIN / "TAppDecoder"), "-b", str(my_bin),
         "-o", str(tmp_path / "hm_rec.yuv")],
        capture_output=True, text=True, check=True)
    oks = re.findall(r"\((OK|\*\*ERR\*\*)\)", r.stdout)
    assert len(oks) == 9 and all(o == "OK" for o in oks), r.stdout

    decoder_main(["-b", str(my_bin), "-o", str(tmp_path / "my_rec.yuv")])
    assert (tmp_path / "my_rec.yuv").read_bytes() == \
        (tmp_path / "hm_rec.yuv").read_bytes()


@pytest.mark.parametrize("fast", [0, 1])
def test_wpp_threaded_compress_byte_identical(oracle, test_clip, tmp_path,
                                              fast, monkeypatch):
    """THEVC_ENC_THREADS>1 row-parallelizes the WPP compress pass
    (slice_encoder._compress_wpp_threaded): worker threads advance CTU
    rows under the wavefront stagger with per-row native encoders over
    shared frame arrays.  The schedule preserves every dependency of the
    sequential loop, so streams must be byte-identical at any thread
    count — on the exact path (which other tests pin byte-exact to HM
    under WPP) and the fast-RD path alike (VERDICT r03 item #5)."""
    outs = {}
    for t in (1, 2, 4):
        monkeypatch.setenv("THEVC_ENC_THREADS", str(t))
        out = tmp_path / f"wpp_t{t}.bin"
        _encode(test_clip, out, 416, 240, 2, 32, fast=fast,
                extra=("--WaveFrontSynchro=1",))
        outs[t] = out.read_bytes()
    assert outs[2] == outs[1]
    assert outs[4] == outs[1]


def test_fast_rd_default_off(oracle, small_clip, tmp_path):
    """FastRD defaults to 0: the stream stays byte-identical to the exact
    path (which the rest of the suite pins byte-exact to HM)."""
    a = tmp_path / "a.bin"
    b = tmp_path / "b.bin"
    _encode(small_clip, a, 96, 80, 1, 32, fast=0)
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(b),
                  "-wdt", "96", "-hgt", "80", "-f", "1", "-fr", "30",
                  "-q", "32", "--SEIpictureDigest=1"])
    assert a.read_bytes() == b.read_bytes()


from tests.test_encoder import small_clip  # noqa: E402,F401  (fixture reuse)
