"""Device decode path: JAX kernel parity + end-to-end digest-exact decode.

The gate VERDICT r02 asked for: the device path (THEVC_DEVICE=1) is
exercised end-to-end on every CI run over the CPU-JAX mesh, so a device-path
regression fails the suite even without a GPU attached.
"""

import io
import contextlib

import numpy as np
import pytest

from thevc.utils.cfg import CFG_DIR
from tests.conftest import TESTDATA

from thevc.ops import deblock as dbk
from thevc.ops import sao as sao_ops


@pytest.fixture(autouse=True)
def _device_on(monkeypatch):
    from thevc.ops import device
    monkeypatch.setenv("THEVC_DEVICE", "1")
    device.reset_cache()
    yield
    device.reset_cache()


def _rand_deblock_inputs(rng, H, W):
    uh, uw = H // 4, W // 4
    flags = rng.rand(uh, uw) < 0.7
    bs = (rng.randint(0, 3, (uh, uw)) * flags).astype(np.uint8)
    qp_p = rng.randint(20, 46, (uh, uw)).astype(np.int32)
    qp_q = rng.randint(20, 46, (uh, uw)).astype(np.int32)
    no_p = (rng.rand(uh, uw) < 0.05)
    no_q = (rng.rand(uh, uw) < 0.05)
    return flags, bs, qp_p, qp_q, no_p, no_q


@pytest.mark.parametrize("bd", [8, 10])
def test_jx_deblock_luma_parity(bd):
    import jax
    from thevc.ops import jx_filters as jf
    rng = np.random.RandomState(7)
    H, W = 64, 96
    maxv = (1 << bd) - 1
    plane = rng.randint(0, maxv + 1, (H, W)).astype(np.int64)
    flags, bs, qp_p, qp_q, no_p, no_q = _rand_deblock_inputs(rng, H, W)
    ref = plane.copy()
    dbk.filter_luma_edges(ref, flags, bs, qp_p, qp_q, no_p, no_q,
                          0, 1, -1, bd)
    fn = jax.jit(lambda *a: jf._luma_dir(*a, 1, -1, bd))
    out = np.asarray(fn(plane.astype(np.int32), flags,
                        bs, qp_p, qp_q,
                        no_p.astype(np.uint8), no_q.astype(np.uint8)))
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("bd", [8, 10])
def test_jx_deblock_chroma_parity(bd):
    import jax
    from thevc.ops import jx_filters as jf
    rng = np.random.RandomState(11)
    H, W = 64, 96
    maxv = (1 << bd) - 1
    cb = rng.randint(0, maxv + 1, (H // 2, W // 2)).astype(np.int64)
    cr = rng.randint(0, maxv + 1, (H // 2, W // 2)).astype(np.int64)
    flags, bs, qp_p, qp_q, no_p, no_q = _rand_deblock_inputs(rng, H, W)
    rcb, rcr = cb.copy(), cr.copy()
    dbk.filter_chroma_edges(rcb, rcr, flags, bs, qp_p, qp_q, no_p, no_q,
                            0, 2, bd)
    fn = jax.jit(lambda *a: jf._chroma_dir(*a, 2, bd))
    ocb, ocr = fn(cb.astype(np.int32), cr.astype(np.int32), flags, bs,
                  qp_p, qp_q, no_p.astype(np.uint8), no_q.astype(np.uint8))
    assert np.array_equal(np.asarray(ocb), rcb)
    assert np.array_equal(np.asarray(ocr), rcr)


@pytest.mark.parametrize("bd", [8, 10])
def test_jx_sao_parity(bd):
    import jax
    from thevc.ops import jx_filters as jf
    rng = np.random.RandomState(13)
    ctu, ctus_w, ctus_h = 32, 3, 2
    H, W = 60, 92        # non-CTU-multiple picture exercises edge CTUs
    maxv = (1 << bd) - 1
    src = rng.randint(0, maxv + 1, (H, W)).astype(np.int16)
    nctu = ctus_w * ctus_h
    sao_type = rng.randint(-1, 5, nctu).astype(np.int32)
    sub_type = rng.randint(0, 32, nctu).astype(np.int32)
    offsets = rng.randint(-7, 8, (nctu, 4)).astype(np.int32)

    ref = sao_ops.apply_sao_plane_ref(src, ctu, sao_type, sub_type,
                                      offsets, ctus_w, ctus_h, bd)
    # the vectorized host form must match the per-CTU reference loop
    vec = sao_ops.apply_sao_plane(src, ctu, sao_type, sub_type, offsets,
                                  ctus_w, ctus_h, bd)
    assert np.array_equal(vec.astype(np.int32), ref.astype(np.int32))

    fn = jax.jit(lambda s, t, bp, o: jf._sao_plane(
        s, t, bp, o, ctu, ctus_w, ctus_h, bd))
    out = np.asarray(fn(src.astype(np.int32), sao_type.astype(np.int8),
                        sub_type, offsets))
    assert np.array_equal(out, ref.astype(np.int32))


def _decode_device(stream_path, out_path):
    from thevc.apps.decoder import main as decoder_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = decoder_main(["-b", str(stream_path), "-o", str(out_path)])
    return rc, buf.getvalue()


def test_device_decode_intra_digest_exact(golden_intra_stream, tmp_path):
    """E2E: all-intra stream through the device path (batched residual on
    device, filter stage as one device launch) — recon byte-identical to
    the HM encoder's and every digest SEI verifies."""
    out = tmp_path / "dev.yuv"
    rc, log = _decode_device(golden_intra_stream["bin"], out)
    assert rc == 0
    assert log.count("(OK)") == golden_intra_stream["frames"]
    assert out.read_bytes() == golden_intra_stream["rec"].read_bytes()


def test_device_decode_sao_digest_exact(oracle, tmp_path):
    """E2E with SAO active: the device SAO stage must be digest-exact."""
    import subprocess
    from tests.conftest import ORACLE_BIN
    clip = TESTDATA / "clip_416x240.yuv"
    ref_bin = TESTDATA / "intra_sao_q32.bin"
    ref_rec = TESTDATA / "intra_sao_q32_rec.yuv"
    if not ref_bin.exists() or not ref_rec.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_intra_main.cfg",
             "-i", str(clip), "-wdt", "416", "-hgt", "240",
             "-f", "2", "-fr", "30", "-b", str(ref_bin),
             "-o", str(ref_rec), "--SEIpictureDigest=1", "--SAO=1"],
            check=True, capture_output=True)
    out = tmp_path / "dev_sao.yuv"
    rc, log = _decode_device(ref_bin, out)
    assert rc == 0
    assert log.count("(OK)") == 2
    assert out.read_bytes() == ref_rec.read_bytes()


def test_device_decode_10bit_digest_exact(oracle, tmp_path):
    """E2E 10-bit (IBDI) decode through the device path."""
    import subprocess
    from tests.conftest import ORACLE_BIN
    clip = TESTDATA / "clip_416x240.yuv"
    ref_bin = TESTDATA / "intra_he10_dev.bin"
    ref_rec = TESTDATA / "intra_he10_dev_rec.yuv"
    if not ref_bin.exists() or not ref_rec.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_intra_he10.cfg",
             "-i", str(clip), "-wdt", "416", "-hgt", "240",
             "-f", "2", "-fr", "30", "-b", str(ref_bin),
             "-o", str(ref_rec), "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "dev10.yuv"
    rc, log = _decode_device(ref_bin, out)
    assert rc == 0
    assert log.count("(OK)") == 2
    assert out.read_bytes() == ref_rec.read_bytes()


def test_fastrd_unified_matches_per_mode_form(monkeypatch):
    """The decision pass has two formulations: the accelerator "unified"
    all-modes gather and the CPU per-mode narrow kernels.  Both must
    produce IDENTICAL decision maps — this is the CI gate that the
    production GPU form computes the same decisions the CPU tests
    validate end-to-end."""
    import numpy as np
    from thevc.encoder import fast_intra as fi

    rng = np.random.RandomState(5)
    y = rng.randint(0, 255, (80, 96)).astype(np.int16)
    yy, xx = np.mgrid[0:80, 0:96]
    y = ((y // 4 + xx * 2 + yy) % 255).astype(np.int16)
    cb = rng.randint(0, 255, (40, 48)).astype(np.int16)
    cr = rng.randint(0, 255, (40, 48)).astype(np.int16)
    args = (y, cb, cr, 96, 80, 32, 30, 30, 57.0, 7.55,
            (1.0, 2.0, 5.5), (0.5, 3.5, 1.1), 4, 2, 64, 0, 255)
    maps_cpu = fi.decide_frame(*args)
    monkeypatch.setenv("THEVC_FASTRD_UNIFIED", "1")
    fi._frame_pass_cache.clear()
    maps_uni = fi.decide_frame(*args)
    fi._frame_pass_cache.clear()
    for a, b in zip(maps_cpu, maps_uni):
        assert np.array_equal(a, b)


def test_device_decode_inter_digest_exact(oracle, tmp_path):
    """E2E on a random-access (B-slice) stream through the device path."""
    import subprocess
    from tests.conftest import ORACLE_BIN
    from tests.conftest import ensure_clip
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    ref_bin = TESTDATA / "dev_ra9.bin"
    ref_rec = TESTDATA / "dev_ra9_rec.yuv"
    if not ref_bin.exists() or not ref_rec.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "9", "-fr", "30", "-b", str(ref_bin),
             "-o", str(ref_rec), "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "dev_ra.yuv"
    rc, log = _decode_device(ref_bin, out)
    assert rc == 0
    assert log.count("(OK)") == 9
    assert out.read_bytes() == ref_rec.read_bytes()


def test_device_decode_multiframe_batched(oracle, tmp_path):
    """Multi-frame batched device decode (VERDICT r03 #3): an all-intra
    stream whose trailing pictures are plain (non-IDR) I slices runs
    stage-1 residuals as one launch per TU size class across the BATCH
    and the in-loop filters as one launch for the batch — recon
    byte-identical to HM's, with <= 3 launches/frame."""
    import subprocess
    from tests.conftest import ORACLE_BIN, ensure_clip
    from thevc.ops import device as device_mod
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    ref_bin = TESTDATA / "dev_intra9.bin"
    ref_rec = TESTDATA / "dev_intra9_rec.yuv"
    if not ref_bin.exists() or not ref_rec.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_intra_main.cfg",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "9", "-fr", "30", "-b", str(ref_bin),
             "-o", str(ref_rec), "--SEIpictureDigest=1", "--SAO=1"],
            check=True, capture_output=True)
    device_mod.stats_reset()
    out = tmp_path / "dev_batched.yuv"
    rc, log = _decode_device(ref_bin, out)
    st = device_mod.stats_reset()
    assert rc == 0
    assert log.count("(OK)") == 9
    assert out.read_bytes() == ref_rec.read_bytes()
    # 9 frames, batch=8: residual classes + one filter launch per batch
    assert st["launches"] / 9 <= 3.0, st
