"""The decoder's residual core (fused dequant + inverse DCT/DST,
jx.residual_pipeline) and fast-RD's SATD helper, against the bit-exact
numpy references.  The same code compiled for the card is checked by the
tests marked `gpu` (tests/test_gpu.py) through chip_smoke.py.
"""

import contextlib
import io

import numpy as np
import pytest

from thevc.utils.cfg import CFG_DIR

from tests.conftest import ensure_clip

PARITY_CASES = [
    (4, False, 0), (4, True, 0), (8, False, 0), (16, False, 0),
    (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2),
]


def _reference(q, qp, use_dst, bit_inc):
    from thevc.ops import transforms as tops
    return tops.inverse_transform(
        tops.dequant(q.astype(np.int32), qp, bit_inc),
        use_dst, bit_inc).astype(np.int16)


@pytest.mark.parametrize("size,use_dst,bit_inc", PARITY_CASES)
def test_pallas_residual_parity(size, use_dst, bit_inc):
    from thevc.ops import jx
    rng = np.random.RandomState(size + bit_inc)
    for n in (64, 129):
        q = rng.randint(-32768, 32768, (n, size, size)).astype(np.int16)
        qp = rng.randint(0, 64, n).astype(np.int32)
        got = np.asarray(jx.residual_pipeline(q, qp, use_dst, bit_inc))
        assert got.dtype == np.int16
        assert np.array_equal(got, _reference(q, qp, use_dst, bit_inc))


def test_residual_pipeline_xla_parity():
    """The decoder's entry point matches the same reference, int32
    coefficients included (clipped to int16 before dequant)."""
    from thevc.ops import jx
    rng = np.random.RandomState(5)
    for size in (4, 8, 16, 32):
        q = rng.randint(-40000, 40000, (33, size, size)).astype(np.int32)
        qp = rng.randint(0, 52, 33).astype(np.int32)
        got = np.asarray(jx.residual_pipeline(q, qp, size == 4, 0))
        ref = _reference(np.clip(q, -32768, 32767), qp, size == 4, 0)
        assert got.dtype == np.int16 and np.array_equal(got, ref)


@pytest.mark.parametrize("size,bit_inc", [(4, 0), (8, 0), (16, 0),
                                          (32, 0), (8, 2), (64, 2)])
def test_pallas_satd_sweep_parity(size, bit_inc):
    """Fast-RD's SATD helper over a 35-candidate sweep equals the host
    reference (encoder.rdcost.calc_had_batched)."""
    import jax.numpy as jnp
    from thevc.encoder.fast_intra import _satd
    from thevc.encoder.rdcost import calc_had_batched
    rng = np.random.RandomState(size + bit_inc)
    hi = 256 << bit_inc
    org = rng.randint(0, hi, (size, size)).astype(np.int32)
    preds = rng.randint(0, hi, (35, size, size)).astype(np.int32)
    ref = np.asarray(calc_had_batched(org, preds, bit_inc))
    got = np.asarray(_satd(jnp.broadcast_to(jnp.asarray(org), preds.shape),
                           jnp.asarray(preds), size, bit_inc))
    assert np.array_equal(got, ref)


def test_pallas_device_decode_digest_exact(tmp_path, monkeypatch):
    """E2E: all-intra device decode (THEVC_DEVICE=1) of our encoder's
    stream — every digest (OK), the output equal to the encoder's recon,
    and the residual core actually called."""
    from thevc.apps.decoder import main as decoder_main
    from thevc.apps.encoder import main as encoder_main
    from thevc.ops import device, jx

    clip = ensure_clip("clip_96x80.yuv", 96, 80, 2)
    bits, rec, out = (tmp_path / "s.bin", tmp_path / "rec.yuv",
                      tmp_path / "dec.yuv")
    with contextlib.redirect_stdout(io.StringIO()):
        encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                      "-i", str(clip), "-wdt", "96", "-hgt", "80",
                      "-f", "2", "-fr", "30", "-q", "27",
                      "-b", str(bits), "-o", str(rec),
                      "--SEIpictureDigest=1"])
    calls = []
    core = jx.residual_pipeline

    def counted(qcoeff, qp, use_dst=False, bit_increment=0):
        calls.append(qcoeff.shape)
        return core(qcoeff, qp, use_dst, bit_increment)

    monkeypatch.setenv("THEVC_DEVICE", "1")
    monkeypatch.setattr(jx, "residual_pipeline", counted)
    device.reset_cache()
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = decoder_main(["-b", str(bits), "-o", str(out)])
        assert rc == 0
        assert buf.getvalue().count("(OK)") == 2
        assert out.read_bytes() == rec.read_bytes()
        assert calls
    finally:
        device.reset_cache()
