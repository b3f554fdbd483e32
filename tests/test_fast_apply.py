"""Device-resident fast-RD apply (encoder/fast_apply.py).

The wavefront apply moves the entire per-frame math (prediction from real
reconstructed neighbors, transform, quant+SBH, recon) into one device
launch; the host does entropy coding only.  Contract:

  1. with RDOQ off, the device apply is BYTE-IDENTICAL to the host
     native fast-RD apply (same plain quant + signBitHidingHDQ math);
  2. with RDOQ on (the default), streams remain fully conformant —
     HM's decoder verifies every digest SEI — at a bounded bit cost for
     trading host RDOQ for in-launch plain quant+SBH;
  3. the batched single-mode predictor is integer-exact against the
     oracle-verified scalar reference (ops.intra.predict).
"""

import os
import re
import subprocess

import numpy as np
import pytest

from thevc.utils.cfg import CFG_DIR
from tests.conftest import ORACLE_BIN

from thevc.apps.decoder import main as decoder_main
from thevc.apps.encoder import main as encoder_main


def _encode(clip, out, w, h, frames, qp, extra=()):
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(clip), "-b", str(out),
                  "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
                  "-fr", "30", "-q", str(qp), "--FastRD=1",
                  "--SEIpictureDigest=1", *extra])


@pytest.fixture
def devapply_env():
    old = {k: os.environ.get(k) for k in
           ("THEVC_FASTRD_DEVAPPLY", "THEVC_FASTRD_TOP2")}
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.parametrize("size,luma", [(4, True), (8, True), (16, True),
                                       (4, False), (8, False), (16, False)])
def test_predict_batch_parity(size, luma):
    """The batched single-mode predictor matches ops.intra.predict for
    every mode (incl. negative-angle side extension, DC/edge filters)."""
    import jax.numpy as jnp
    from thevc.ops import intra as iops
    from thevc.encoder.fast_apply import _predict_batch

    rng = np.random.RandomState(7)
    unit = 4 if luma else 2
    line = rng.randint(0, 256, 4 * size + unit).astype(np.int32)
    sm = iops.smooth_reference_line(line, size, unit)

    def refs_of(src):
        corner = src[2 * size]
        ra = np.concatenate([[corner], src[2 * size + unit:]])
        rl = np.concatenate([[corner], src[2 * size - 1::-1][:2 * size]])
        return ra, rl

    ra, rl = refs_of(line)
    out = np.asarray(_predict_batch(
        jnp.asarray(np.tile(ra, (35, 1)), jnp.int32),
        jnp.asarray(np.tile(rl, (35, 1)), jnp.int32),
        size, luma, jnp.arange(35, dtype=jnp.int32), 255))
    for mode in range(35):
        use_f = iops.use_filtered(mode, size.bit_length() - 1, luma)
        ref = iops.predict(sm if use_f else line, size, unit, mode, luma,
                           255)
        assert np.array_equal(out[mode], ref), f"mode {mode}"


def test_device_apply_byte_identical_rdoq0(small_clip, tmp_path,
                                           devapply_env):
    """With RDOQ off the device wavefront apply reproduces the host
    native fast-RD apply bit-for-bit (plain quant + SBH parity over the
    whole closed loop: schedule, availability clamp, prediction, T/Q,
    recon, cbf/fill, CABAC)."""
    os.environ["THEVC_FASTRD_TOP2"] = "0"
    outs = {}
    for v in ("0", "force"):
        os.environ["THEVC_FASTRD_DEVAPPLY"] = v
        out = tmp_path / f"da_{v}.bin"
        _encode(small_clip, out, 96, 80, 3, 30, extra=("--RDOQ=0",))
        outs[v] = out.read_bytes()
    assert outs["0"] == outs["force"]


def test_device_apply_conformant_rdoq_default(oracle, test_clip, tmp_path,
                                              devapply_env):
    """Default config (RDOQ on): the device-apply stream decodes with all
    HM digest checks OK, our decoder round-trips it, and trading RDOQ for
    in-launch quant+SBH costs a bounded bit overhead."""
    os.environ["THEVC_FASTRD_DEVAPPLY"] = "0"
    host_bin = tmp_path / "host.bin"
    _encode(test_clip, host_bin, 416, 240, 2, 32)
    os.environ["THEVC_FASTRD_DEVAPPLY"] = "force"
    dev_bin = tmp_path / "dev.bin"
    _encode(test_clip, dev_bin, 416, 240, 2, 32)

    r = subprocess.run(
        [str(ORACLE_BIN / "TAppDecoder"), "-b", str(dev_bin),
         "-o", str(tmp_path / "hm_rec.yuv")],
        capture_output=True, text=True, check=True)
    oks = re.findall(r"\((OK|\*\*ERR\*\*)\)", r.stdout)
    assert oks and all(o == "OK" for o in oks), r.stdout

    decoder_main(["-b", str(dev_bin), "-o", str(tmp_path / "my_rec.yuv")])
    assert (tmp_path / "my_rec.yuv").read_bytes() == \
        (tmp_path / "hm_rec.yuv").read_bytes()

    host_sz = host_bin.stat().st_size
    dev_sz = dev_bin.stat().st_size
    # catastrophe bound only: host runs full RDOQ + closed-loop re-rank;
    # the in-launch RDOQ-lite recovers most but not all of that
    # (plain quant alone measures ~+48% on this content — the gap IS rdoq)
    assert dev_sz <= host_sz * 1.60, (host_sz, dev_sz)


def test_fast_rd_rate_control_conformant(oracle, test_clip, tmp_path,
                                         devapply_env):
    """Fast-RD + rate control (VERDICT r04 item #6): the frame QP comes
    from the rate controller, per-LCU stats feed its models from the
    counter pass, and the stream stays fully conformant (HM digest-
    verified) while tracking the target rate."""
    os.environ["THEVC_FASTRD_DEVAPPLY"] = "force"
    out = tmp_path / "rc.bin"
    target_kbps = 1000
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(test_clip), "-b", str(out),
                  "-wdt", "416", "-hgt", "240", "-f", "4", "-fr", "30",
                  "--FastRD=1", "--RateControl=1",
                  f"--TargetBitrate={target_kbps * 1000}",
                  "--SEIpictureDigest=1"])
    r = subprocess.run(
        [str(ORACLE_BIN / "TAppDecoder"), "-b", str(out),
         "-o", str(tmp_path / "hm_rec.yuv")],
        capture_output=True, text=True, check=True)
    oks = re.findall(r"\((OK|\*\*ERR\*\*)\)", r.stdout)
    assert oks and all(o == "OK" for o in oks), r.stdout
    decoder_main(["-b", str(out), "-o", str(tmp_path / "my_rec.yuv")])
    assert (tmp_path / "my_rec.yuv").read_bytes() == \
        (tmp_path / "hm_rec.yuv").read_bytes()
    # rate tracking: frame-level control only, so allow generous slack
    kbps = out.stat().st_size * 8 * 30 / 4 / 1000.0
    assert kbps < target_kbps * 2.5, kbps


from tests.test_encoder import small_clip  # noqa: E402,F401  (fixture reuse)
