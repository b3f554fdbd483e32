"""Encoder conformance: byte-exact bitstreams vs the HM oracle encoder.

The all-intra encoder must make the reference's exact RD decisions
(SURVEY.md section 4: decision-equality, not just conformance) — the
output stream is compared byte-for-byte against TAppEncoder's.
"""

import subprocess

import pytest

from thevc.utils.cfg import CFG_DIR
from tests.conftest import ORACLE_BIN, TESTDATA, REPO, ensure_clip

from thevc.apps.encoder import main as encoder_main


def _oracle_encode(clip, out_bin, w, h, frames, extra, digest=1):
    cmd = [str(ORACLE_BIN / "TAppEncoder"),
           "-c", f"{CFG_DIR}/encoder_intra_main.cfg",
           "-i", str(clip), "-wdt", str(w), "-hgt", str(h),
           "-f", str(frames), "-fr", "30",
           "-b", str(out_bin), "-o", "/dev/null",
           f"--SEIpictureDigest={digest}", *extra]
    subprocess.run(cmd, check=True, capture_output=True)


@pytest.fixture(scope="session")
def small_clip():
    TESTDATA.mkdir(exist_ok=True)
    clip = TESTDATA / "clip_96x80.yuv"
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "96", "--height", "80", "--frames", "2"],
            check=True)
    return clip


@pytest.mark.parametrize("qp", [22, 32, 51])
def test_intra_encode_byte_exact(oracle, small_clip, tmp_path, qp):
    """All-intra Main, SAO off, TS+RDOQ+SBH on: byte-exact vs HM."""
    hm_bin = TESTDATA / f"enc_intra_q{qp}_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(small_clip, hm_bin, 96, 80, 2,
                       ["-q", str(qp), "--SAO=0"])
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "2", "-fr", "30",
                  "-q", str(qp), "--SAO=0", "--SEIpictureDigest=1"])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


def test_intra_encode_no_ts_byte_exact(oracle, small_clip, tmp_path):
    """Transform-skip disabled variant (exercises plain RDOQ path)."""
    hm_bin = TESTDATA / "enc_intra_q32_nots_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(small_clip, hm_bin, 96, 80, 2,
                       ["-q", "32", "--SAO=0", "--TS=0", "--TSFast=0"])
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "2", "-fr", "30",
                  "-q", "32", "--SAO=0", "--TS=0", "--TSFast=0",
                  "--SEIpictureDigest=1"])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


def test_encode_decode_roundtrip(oracle, small_clip, tmp_path):
    """Our stream decodes in the HM oracle decoder with matching digests."""
    my_bin = tmp_path / "rt.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "2", "-fr", "30",
                  "-q", "37", "--SAO=0", "--SEIpictureDigest=1"])
    out = subprocess.run(
        [str(ORACLE_BIN / "TAppDecoder"), "-b", str(my_bin),
         "-o", str(tmp_path / "rt_dec.yuv")],
        check=True, capture_output=True, text=True)
    assert "(OK)" in out.stdout and "(***ERROR***)" not in out.stdout


def test_intra_encode_10bit_byte_exact(oracle, small_clip, tmp_path):
    """IBDI (InternalBitDepth=10) path: byte-exact vs HM."""
    hm_bin = TESTDATA / "enc_intra_q27_10b_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(small_clip, hm_bin, 96, 80, 1,
                       ["-q", "27", "--SAO=0", "--InternalBitDepth=10"])
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "1", "-fr", "30",
                  "-q", "27", "--SAO=0", "--InternalBitDepth=10",
                  "--SEIpictureDigest=1"])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


@pytest.mark.parametrize("dig", [2, 3])
def test_intra_encode_crc_checksum_digest_byte_exact(oracle, small_clip,
                                                     tmp_path, dig):
    """CRC (bottom-fed CRC-16/CCITT long division, TComPicYuvMD5.cpp:86)
    and checksum decoded-picture-hash SEIs: byte-exact vs HM."""
    hm_bin = TESTDATA / f"enc_intra_dig{dig}_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(small_clip, hm_bin, 96, 80, 1, ["-q", "32"],
                       digest=dig)
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "1", "-fr", "30",
                  "-q", "32", f"--SEIpictureDigest={dig}"])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


@pytest.mark.parametrize("qp", [27, 37])
def test_intra_encode_sao_byte_exact(oracle, small_clip, tmp_path, qp):
    """Full default toolset incl. the SAO encoder: byte-exact vs HM."""
    hm_bin = TESTDATA / f"enc_intra_sao_q{qp}_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(small_clip, hm_bin, 96, 80, 2, ["-q", str(qp)])
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "2", "-fr", "30",
                  "-q", str(qp), "--SEIpictureDigest=1"])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


def test_encoder_lowdelay_p_byte_exact(oracle, test_clip_small, tmp_path):
    """P-slice inter encoder: byte-exact bitstream vs the reference with
    the unmodified lowdelay_P configuration (ME/merge/AMP/RQT/GOP)."""
    ref_bin = TESTDATA / "enc_ldp5_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_lowdelay_P_main.cfg",
             "-i", str(test_clip_small), "-wdt", "176", "-hgt", "144",
             "-f", "5", "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "ldp5.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_lowdelay_P_main.cfg",
              "-i", str(test_clip_small), "-wdt", "176", "-hgt", "144",
              "-f", "5", "-fr", "30", "-b", str(out),
              "-o", "/dev/null", "--SEIpictureDigest=1"])
    assert out.read_bytes() == ref_bin.read_bytes()


def test_encoder_lowdelay_b_byte_exact(oracle, small_clip, tmp_path):
    """B-slice inter encoder (lowdelay_main): bi-prediction, GPB combined
    list with the L1-from-L0 cost derivation (GPB_SIMPLE_UNI), and the
    encoder's CABAC init-table selection (determineCabacInitIdx)."""
    import shutil
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "96", "--height", "80", "--frames", "9"],
            check=True)
    ref_bin = TESTDATA / "enc_ldb5_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_lowdelay_main.cfg",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "5", "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "ldb5.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_lowdelay_main.cfg",
                  "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", "5", "-fr", "30", "-b", str(out),
                  "-o", "/dev/null", "--SEIpictureDigest=1"])
    assert out.read_bytes() == ref_bin.read_bytes()


# ---------------------------------------------------------------------------
# Frame partitioning on the encode side: slices / dependent slices / tiles /
# WPP (TEncGOP.cpp:560-625 segmentation, TEncSlice.cpp compress/encode
# passes, substream concat + entry points TEncGOP.cpp:904-976)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,extra", [
    ("slices", ["--SliceMode=1", "--SliceArgument=2"]),
    ("tiles", ["--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1"]),
    ("wpp", ["--WaveFrontSynchro=1"]),
    ("dep", ["--DependentSliceMode=1", "--DependentSliceArgument=2"]),
    ("depw", ["--DependentSliceMode=1", "--DependentSliceArgument=1",
              "--WaveFrontSynchro=1"]),
    ("tiles_slices", ["--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1",
                      "--SliceMode=1", "--SliceArgument=1"]),
    # byte-budget slices (end discovered dynamically in finishCU,
    # TEncCu.cpp:1065-1070 + TEncSlice.cpp:922)
    ("bytes", ["--SliceMode=2", "--SliceArgument=120"]),
    # tiles-in-slice (TEncSlice.cpp:1428-1448 tile increment)
    ("tslice", ["--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1",
                "--SliceMode=3", "--SliceArgument=1"]),
    # bin-budget dependent slices (TEncCu.cpp:1077, mid-CTU encode abort
    # + the MPM left-neighbor dependent-slice restriction)
    ("depbins", ["--DependentSliceMode=2", "--DependentSliceArgument=1200"]),
])
def test_encode_partitioned_byte_exact(oracle, small_clip, tmp_path,
                                       name, extra):
    """Multi-slice / tiles / WPP / dependent-slice encode: byte-exact."""
    hm_bin = TESTDATA / f"enc_part_{name}_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(small_clip, hm_bin, 96, 80, 2, extra)
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(small_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "2", "-fr", "30",
                  "--SEIpictureDigest=1", *extra])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


@pytest.mark.parametrize("name,cfg,frames,extra", [
    # tool COMBINATIONS that share state across partition boundaries in HM
    # (VERDICT r02 weak #5): quadtree SAO x slices/tiles
    # (TEncSampleAdaptiveOffset.cpp:1466), rate control x tiles/WPP
    # (TEncSlice.cpp:816-821), AQ x multi-slice
    ("qtsao_slices", "encoder_intra_main.cfg", 2,
     ["--SAOLcuBasedOptimization=0", "--SliceMode=1", "--SliceArgument=2"]),
    ("qtsao_tiles", "encoder_intra_main.cfg", 2,
     ["--SAOLcuBasedOptimization=0", "--UniformSpacingIdc=1",
      "--NumTileColumnsMinus1=1"]),
    ("rc_tiles", "encoder_lowdelay_P_main.cfg", 5,
     ["--RateControl=1", "--TargetBitrate=100000",
      "--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1"]),
    ("rc_wpp", "encoder_lowdelay_P_main.cfg", 5,
     ["--RateControl=1", "--TargetBitrate=100000",
      "--WaveFrontSynchro=1"]),
    ("aq_slices", "encoder_intra_main.cfg", 2,
     ["--AdaptiveQP=1", "--MaxQPAdaptationRange=6",
      "--SliceMode=1", "--SliceArgument=2"]),
])
def test_encoder_tool_combinations_byte_exact(oracle, tmp_path, name, cfg,
                                              frames, extra):
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    ref_bin = TESTDATA / f"combo_{name}_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/{cfg}",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", str(frames), "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1", *extra],
            check=True, capture_output=True)
    out = tmp_path / "combo.bin"
    encoder_main(["-c", f"{CFG_DIR}/{cfg}",
                  "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", str(frames), "-fr", "30", "-b", str(out),
                  "-o", "/dev/null", "--SEIpictureDigest=1", *extra])
    assert out.read_bytes() == ref_bin.read_bytes()


@pytest.mark.parametrize("extra,name", [
    (["--LambdaModifier0=1.4"], "lm0"),
    (["-LM1", "0.7"], "lm1"),
    (["--RecalculateQPAccordingToLambda=1"], "recalc"),
])
def test_encoder_lambda_modifier_byte_exact(oracle, tmp_path, extra, name):
    """LambdaModifier0-7 / RecalculateQPAccordingToLambda
    (TAppEncCfg.cpp:219-226/:327, TEncSlice.cpp:313-316/:352-357)."""
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    cfg = (f"{CFG_DIR}/encoder_lowdelay_main.cfg" if name != "lm1"
           else str(REPO / "tests" / "cfg" / "encoder_lowdelay_tlayers.cfg"))
    ref_bin = TESTDATA / f"lm_{name}_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"), "-c", cfg,
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "4", "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1", *extra],
            check=True, capture_output=True)
    out = tmp_path / "lm.bin"
    encoder_main(["-c", cfg, "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", "4", "-fr", "30", "-b", str(out),
                  "-o", "/dev/null", "--SEIpictureDigest=1", *extra])
    assert out.read_bytes() == ref_bin.read_bytes()


@pytest.mark.parametrize("mode,w,h,extra", [
    (1, 92, 76, []),
    (2, 92, 76, ["--HorizontalPadding=4", "--VerticalPadding=4"]),
    (3, 96, 80, ["--CropLeft=8", "--CropRight=8",
                 "--CropTop=4", "--CropBottom=4"]),
])
def test_encoder_cropping_modes_byte_exact(oracle, tmp_path, mode, w, h,
                                           extra):
    """CroppingMode 1 (auto-pad to min CU), 2 (explicit pad), 3 (crop):
    source padding by edge extension, SPS cropping window, cropped recon
    output (TAppEncCfg.cpp:365-393, TVideoIOYuv read/write)."""
    clip = TESTDATA / f"clip_{w}x{h}_2f.yuv"
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", str(w), "--height", str(h), "--frames", "2"],
            check=True)
    args = ["-wdt", str(w), "-hgt", str(h), "-f", "2", "-fr", "30",
            "--SEIpictureDigest=1", f"--CroppingMode={mode}", *extra]
    cfg = f"{CFG_DIR}/encoder_intra_main.cfg"
    ref_bin = tmp_path / "crop_ref.bin"
    ref_rec = tmp_path / "crop_ref.yuv"
    subprocess.run(
        [str(ORACLE_BIN / "TAppEncoder"), "-c", cfg, "-i", str(clip),
         "-b", str(ref_bin), "-o", str(ref_rec), *args],
        check=True, capture_output=True)
    out = tmp_path / "crop_my.bin"
    rec = tmp_path / "crop_my.yuv"
    encoder_main(["-c", cfg, "-i", str(clip), "-b", str(out),
                  "-o", str(rec), *args])
    assert out.read_bytes() == ref_bin.read_bytes()
    assert rec.read_bytes() == ref_rec.read_bytes()
    # decoder side: our decoder applies the SPS cropping window on output
    from thevc.apps.decoder import main as decoder_main
    dec_ref = tmp_path / "dec_ref.yuv"
    dec_my = tmp_path / "dec_my.yuv"
    subprocess.run([str(ORACLE_BIN / "TAppDecoder"), "-b", str(out),
                    "-o", str(dec_ref)], check=True, capture_output=True)
    decoder_main(["-b", str(out), "-o", str(dec_my)])
    assert dec_my.read_bytes() == dec_ref.read_bytes()


def test_encoder_midstream_cra_tfd_byte_exact(oracle, small_clip, tmp_path):
    """Mid-stream CRA: leading pictures get TFD NAL typing (TEncGOP.cpp:
    1745-1756) and the CRA refresh marking (TComSlice::decodingRefresh-
    Marking :646) unreferences pre-CRA pictures.  IntraPeriod=8 over 9
    frames puts a CRA at POC 8 with 7 TFD leading pictures."""
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "96", "--height", "80", "--frames", "9"],
            check=True)
    ref_bin = TESTDATA / "tfd_ra9_ip8_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "9", "-fr", "30", "--IntraPeriod=8", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "tfd9.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
                  "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", "9", "-fr", "30", "--IntraPeriod=8", "-b", str(out),
                  "-o", "/dev/null", "--SEIpictureDigest=1"])
    assert out.read_bytes() == ref_bin.read_bytes()
    from thevc.nal import iter_annexb_nals
    types = [n.nal_type for n in iter_annexb_nals(out.read_bytes())
             if n.nal_type < 25]
    assert types == [8, 4] + [2] * 7  # IDR, CRA, 7x TFD


@pytest.mark.slow
def test_encoder_two_intra_periods_byte_exact(oracle, tmp_path):
    """Two full intra periods: the second CRA triggers the pending refresh
    marking and the trailing GOP's RPSs reference unreferenced pictures,
    forcing explicit slice-header RPSs (TComSlice::createExplicitReference-
    PictureSetFromReference :1052) with inter-RPS prediction."""
    clip = TESTDATA / "clip_96x80_24f.yuv"
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "96", "--height", "80", "--frames", "24"],
            check=True)
    ref_bin = TESTDATA / "tfd_ra_ip16f24_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "24", "-fr", "30", "--IntraPeriod=16", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "tfd24.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
                  "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", "24", "-fr", "30", "--IntraPeriod=16",
                  "-b", str(out), "-o", "/dev/null", "--SEIpictureDigest=1"])
    assert out.read_bytes() == ref_bin.read_bytes()


def test_encoder_temporal_layers_tla_byte_exact(oracle, tmp_path):
    """2-temporal-layer low-delay GOP: every TId-1 picture is a temporal
    switching point and is typed TLA (TEncGOP.cpp:299-305,
    TComSlice::isTemporalLayerSwitchingPoint :838)."""
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    cfg = str(REPO / "tests" / "cfg" / "encoder_lowdelay_tlayers.cfg")
    ref_bin = TESTDATA / "tla_ld5_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"), "-c", cfg,
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "5", "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "tla5.bin"
    encoder_main(["-c", cfg, "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", "5", "-fr", "30", "-b", str(out),
                  "-o", "/dev/null", "--SEIpictureDigest=1"])
    assert out.read_bytes() == ref_bin.read_bytes()
    from thevc.nal import iter_annexb_nals
    types = [(n.nal_type, n.temporal_id)
             for n in iter_annexb_nals(out.read_bytes()) if n.nal_type < 25]
    assert types == [(8, 0), (3, 1), (1, 0), (3, 1), (1, 0)]


def test_encoder_randomaccess_byte_exact(oracle, small_clip, tmp_path):
    """Random-access hierarchical-B GOP (GOPSize=8, CRA refresh): byte-exact
    (TEncGOP::getNalUnitType, bi-pred iteration, colDir alternation)."""
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "96", "--height", "80", "--frames", "9"],
            check=True)
    ref_bin = TESTDATA / "enc_ra9_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "9", "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "ra9.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_randomaccess_main.cfg",
                  "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", "9", "-fr", "30", "-b", str(out),
                  "-o", "/dev/null", "--SEIpictureDigest=1"])
    assert out.read_bytes() == ref_bin.read_bytes()


@pytest.mark.parametrize("cfg,frames,name", [
    ("encoder_intra_main.cfg", 2, "intra"),
    ("encoder_lowdelay_P_main.cfg", 3, "ldp"),
])
def test_encoder_scaling_list_byte_exact(oracle, small_clip, tmp_path,
                                         cfg, frames, name):
    if frames > 2:
        small_clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    """--ScalingList=1 (default matrices): per-coefficient quant/RDOQ err
    scale tables (TComTrQuant::xSetScalingListEnc/setErrScaleCoeff)."""
    ref_bin = TESTDATA / f"enc_sl1_{name}_96x80.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/{cfg}",
             "-i", str(small_clip), "-wdt", "96", "-hgt", "80",
             "-f", str(frames), "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1", "--ScalingList=1"],
            check=True, capture_output=True)
    out = tmp_path / "sl1.bin"
    encoder_main(["-c", f"{CFG_DIR}/{cfg}",
                  "-i", str(small_clip), "-wdt", "96", "-hgt", "80",
                  "-f", str(frames), "-fr", "30", "-b", str(out),
                  "--SEIpictureDigest=1", "--ScalingList=1"])
    assert out.read_bytes() == ref_bin.read_bytes()


def test_encoder_weighted_pred_byte_exact(oracle, tmp_path):
    """-wpP on a fade clip: AC/DC WP analysis (WeightPredAnalysis.cpp),
    weighted ME/RD, and the pred_weight_table syntax — byte-exact."""
    from test_decoder import _make_fade_clip
    clip = TESTDATA / "clip_fade_176x144.yuv"
    if not clip.exists():
        _make_fade_clip(clip)
    ref_bin = TESTDATA / "enc_wpP3_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_lowdelay_P_main.cfg",
             "-i", str(clip), "-wdt", "176", "-hgt", "144",
             "-f", "3", "-fr", "30", "-wpP", "1", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    out = tmp_path / "wp.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_lowdelay_P_main.cfg",
                  "-i", str(clip), "-wdt", "176", "-hgt", "144",
                  "-f", "3", "-fr", "30", "-wpP", "1", "-b", str(out),
                  "--SEIpictureDigest=1"])
    assert out.read_bytes() == ref_bin.read_bytes()


@pytest.mark.parametrize("cfg,kbps,name", [
    ("encoder_lowdelay_P_main.cfg", 100000, "ldp"),
    ("encoder_randomaccess_main.cfg", 50000, "ra"),
])
def test_encoder_rate_control_byte_exact(oracle, tmp_path, cfg, kbps, name):
    """--RateControl=1: MAD linear + URQ quadratic models, frame-level QP
    and LCU-level unit QP with per-LCU dQP signalling (TEncRateCtrl.cpp:60,
    :99, :321, :429; hooks TEncSlice.cpp:249,:814,:969,:991)."""
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "96", "--height", "80", "--frames", "9"],
            check=True)
    ref_bin = TESTDATA / f"enc_rc_{name}_ref.bin"
    if not ref_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/{cfg}",
             "-i", str(clip), "-wdt", "96", "-hgt", "80",
             "-f", "9", "-fr", "30", "-b", str(ref_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1",
             "--RateControl=1", f"--TargetBitrate={kbps}"],
            check=True, capture_output=True)
    out = tmp_path / "rc.bin"
    encoder_main(["-c", f"{CFG_DIR}/{cfg}",
                  "-i", str(clip), "-wdt", "96", "-hgt", "80",
                  "-f", "9", "-fr", "30", "-b", str(out),
                  "-o", "/dev/null", "--SEIpictureDigest=1",
                  "--RateControl=1", f"--TargetBitrate={kbps}"])
    assert out.read_bytes() == ref_bin.read_bytes()


@pytest.fixture(scope="session")
def noise_clip():
    """High-entropy clip: PCM wins the RD race at low QP."""
    TESTDATA.mkdir(exist_ok=True)
    clip = TESTDATA / "noise_96x80.yuv"
    if not clip.exists():
        import numpy as np
        rng = np.random.RandomState(7)
        w, h = 96, 80
        with open(clip, "wb") as fh:
            fh.write(rng.randint(0, 256, (h, w), np.uint8).tobytes())
            fh.write(rng.randint(0, 256, (h // 2, w // 2), np.uint8).tobytes())
            fh.write(rng.randint(0, 256, (h // 2, w // 2), np.uint8).tobytes())
    return clip


def test_intra_encode_pcm_byte_exact(oracle, noise_clip, tmp_path):
    """PCM mode decision + burst-IPCM write (xCheckIntraPCM TEncCu.cpp:1469,
    codeIPCMInfo TEncSbac.cpp:1008): byte-exact vs HM on content where PCM
    is actually selected, and digest-exact self-decode."""
    hm_bin = TESTDATA / "enc_pcm_noise_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(noise_clip, hm_bin, 96, 80, 1,
                       ["-q", "0", "--PCMEnabledFlag=1"])
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(noise_clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "1", "-fr", "30",
                  "-q", "0", "--PCMEnabledFlag=1", "--SEIpictureDigest=1"])
    assert my_bin.read_bytes() == hm_bin.read_bytes()

    # the stream must actually contain PCM CUs, and self-decode digest-OK
    import thevc.decoder.cu_parser as cp
    import thevc.decoder.native_parse as npx
    from thevc.decoder.top import Decoder
    n_pcm = [0]
    orig_ipcm = cp.SliceDataParser._parse_ipcm
    orig_native = npx.parse_slice_native

    def counting_ipcm(self, abs_part, depth):
        orig_ipcm(self, abs_part, depth)
        ux, uy = self._unit_xy(abs_part)
        if self.f.ipcm[uy, ux]:
            n_pcm[0] += 1

    cp.SliceDataParser._parse_ipcm = counting_ipcm
    npx.parse_slice_native = lambda *a, **k: (False, None)
    try:
        pics = Decoder().decode_stream(my_bin.read_bytes())
    finally:
        cp.SliceDataParser._parse_ipcm = orig_ipcm
        npx.parse_slice_native = orig_native
    assert all(p.digest_ok for p in pics)
    assert n_pcm[0] > 0


@pytest.mark.parametrize("cfg,frames,name", [
    ("encoder_intra_main.cfg", 1, "intra"),
    ("encoder_lowdelay_P_main.cfg", 3, "ldp"),
])
def test_lossless_encode_byte_exact(oracle, test_clip_small, tmp_path,
                                    cfg, frames, name):
    """CU transquant bypass encode (TComTrQuant.cpp:1388 bypass,
    TEncSearch.cpp:4629/4990 lossless RD rules, TEncCu.cpp:1269 merge
    iteration): byte-exact vs HM."""
    opts = ["--LosslessCuEnabled=1", "--TransquantBypassEnableFlag=1",
            "--CUTransquantBypassFlagValue=1"]
    hm_bin = TESTDATA / f"enc_lossless_{name}.bin"
    if not hm_bin.exists():
        cmd = [str(ORACLE_BIN / "TAppEncoder"),
               "-c", f"{CFG_DIR}/{cfg}",
               "-i", str(test_clip_small), "-wdt", "176", "-hgt", "144",
               "-f", str(frames), "-fr", "30", "-b", str(hm_bin),
               "-o", "/dev/null", "--SEIpictureDigest=1", *opts]
        subprocess.run(cmd, check=True, capture_output=True)
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/{cfg}",
                  "-i", str(test_clip_small), "-b", str(my_bin),
                  "-wdt", "176", "-hgt", "144", "-f", str(frames),
                  "-fr", "30", "--SEIpictureDigest=1", *opts])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


def test_encoder_auto_inter_rps_byte_exact(oracle, test_clip_small, tmp_path):
    """InterRPSPrediction=2 (AUTO_INTER_RPS, TEncTop.cpp:699-730): refIdc
    derived automatically from the previous RPS; byte-exact vs HM."""
    import re
    cfg_in = open(f"{CFG_DIR}/encoder_lowdelay_P_main.cfg").read()
    cfg_auto = re.sub(r"1      -1       5         [01 ]+", "2      -1",
                      cfg_in)
    cfg_path = tmp_path / "ldp_auto.cfg"
    cfg_path.write_text(cfg_auto)
    hm_bin = TESTDATA / "enc_auto_rps.bin"
    if not hm_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"), "-c", str(cfg_path),
             "-i", str(test_clip_small), "-wdt", "176", "-hgt", "144",
             "-f", "5", "-fr", "30", "-b", str(hm_bin), "-o", "/dev/null",
             "--SEIpictureDigest=1"], check=True, capture_output=True)
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", str(cfg_path), "-i", str(test_clip_small),
                  "-b", str(my_bin), "-wdt", "176", "-hgt", "144",
                  "-f", "5", "-fr", "30", "--SEIpictureDigest=1"])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


@pytest.mark.parametrize("cfg,frames,extra,name", [
    ("encoder_intra_main.cfg", 2,
     ["--AdaptiveQP=1"], "aq_intra"),
    ("encoder_intra_main.cfg", 1,
     ["--AdaptiveQP=1", "--MaxQPAdaptationRange=4"], "aq_r4"),
    # MaxCuDQPDepth>0: per-depth psycho-visual offsets with sub-CTU dQP
    # coding (TEncCu.cpp:425-446 QP gating, TEncPic AQ layers)
    ("encoder_intra_main.cfg", 1,
     ["--AdaptiveQP=1", "--MaxCuDQPDepth=1"], "aq_dqd1"),
    ("encoder_intra_main.cfg", 1,
     ["--AdaptiveQP=1", "--MaxCuDQPDepth=2"], "aq_dqd2"),
    ("encoder_lowdelay_P_main.cfg", 3,
     ["--AdaptiveQP=1", "--MaxCuDQPDepth=2"], "aq_dqd2_ldp"),
    ("encoder_lowdelay_P_main.cfg", 3,
     ["--AdaptiveQP=1"], "aq_ldp"),
])
def test_encoder_adaptive_qp_byte_exact(oracle, test_clip_small, tmp_path,
                                        cfg, frames, extra, name):
    """AdaptiveQP (TEncPreanalyzer xPreanalyze + TEncCu::xComputeQP psycho-
    visual offsets + xCheckDQP dQP-bit RDO and no-cbf QP inheritance):
    byte-exact vs HM."""
    hm_bin = TESTDATA / f"enc_{name}.bin"
    if not hm_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"), "-c",
             f"{CFG_DIR}/{cfg}",
             "-i", str(test_clip_small), "-wdt", "176", "-hgt", "144",
             "-f", str(frames), "-fr", "30", "-b", str(hm_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1", *extra],
            check=True, capture_output=True)
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/{cfg}",
                  "-i", str(test_clip_small), "-b", str(my_bin),
                  "-wdt", "176", "-hgt", "144", "-f", str(frames),
                  "-fr", "30", "--SEIpictureDigest=1", *extra])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


@pytest.mark.parametrize("cfg,frames,name", [
    ("encoder_intra_main.cfg", 2, "saoqt_intra"),
    ("encoder_lowdelay_P_main.cfg", 3, "saoqt_ldp"),
])
def test_encoder_sao_quadtree_byte_exact(oracle, test_clip_small, tmp_path,
                                         cfg, frames, name):
    """Picture-based (quadtree) SAO RDO, SAOLcuBasedOptimization=0
    (TEncSampleAdaptiveOffset runQuadTreeDecision/rdoSaoOnePart +
    assignSaoUnitSyntax/convertQT2SaoUnit): byte-exact vs HM."""
    extra = ["--SAOLcuBasedOptimization=0"]
    hm_bin = TESTDATA / f"enc_{name}.bin"
    if not hm_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"), "-c",
             f"{CFG_DIR}/{cfg}",
             "-i", str(test_clip_small), "-wdt", "176", "-hgt", "144",
             "-f", str(frames), "-fr", "30", "-b", str(hm_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1", *extra],
            check=True, capture_output=True)
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/{cfg}",
                  "-i", str(test_clip_small), "-b", str(my_bin),
                  "-wdt", "176", "-hgt", "144", "-f", str(frames),
                  "-fr", "30", "--SEIpictureDigest=1", *extra])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


@pytest.mark.parametrize("extra,name", [
    (["--SAOLcuBasedOptimization=0"], "saoqt10"),
    (["--AdaptiveQP=1"], "aq10"),
])
def test_encoder_10bit_tool_byte_exact(oracle, small_clip, tmp_path, extra,
                                       name):
    """IBDI (InternalBitDepth=10) interaction with quadtree SAO (xRoundIbdi2
    rounding, offset threshold) and AdaptiveQP: byte-exact vs HM."""
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    hm_bin = TESTDATA / f"enc_{name}_96x80.bin"
    if not hm_bin.exists():
        _oracle_encode(clip, hm_bin, 96, 80, 2,
                       ["--InternalBitDepth=10", *extra])
    my_bin = tmp_path / "my.bin"
    encoder_main(["-c", f"{CFG_DIR}/encoder_intra_main.cfg",
                  "-i", str(clip), "-b", str(my_bin),
                  "-wdt", "96", "-hgt", "80", "-f", "2", "-fr", "30",
                  "--InternalBitDepth=10", "--SEIpictureDigest=1", *extra])
    assert my_bin.read_bytes() == hm_bin.read_bytes()


def test_encoder_checkpoint_resume_byte_exact(test_clip_small, tmp_path):
    """Checkpoint/resume: all cross-frame encoder state is explicit and
    serializable (SURVEY.md section 5), so an encode split at a GOP-aligned
    checkpoint and resumed in a fresh process produces the identical
    bitstream and recon as the uninterrupted run."""
    clip = ensure_clip("clip_96x80_9f.yuv", 96, 80, 9)
    cfg = f"{CFG_DIR}/encoder_lowdelay_P_main.cfg"
    base = ["-c", cfg, "-i", str(clip), "-wdt", "96", "-hgt", "80",
            "-fr", "30", "--SEIpictureDigest=1"]

    full_bin = tmp_path / "full.bin"
    full_rec = tmp_path / "full.yuv"
    encoder_main(base + ["-f", "9", "-b", str(full_bin), "-o",
                         str(full_rec)])

    ck = tmp_path / "state.pkl"
    j_bin = tmp_path / "joined.bin"
    j_rec = tmp_path / "joined.yuv"
    encoder_main(base + ["-f", "5", "-b", str(j_bin), "-o", str(j_rec),
                         "--CheckpointFile=" + str(ck),
                         "--CheckpointEvery=1"])
    assert ck.exists()
    encoder_main(base + ["-f", "9", "-b", str(j_bin), "-o", str(j_rec),
                         "--ResumeFile=" + str(ck)])

    assert j_bin.read_bytes() == full_bin.read_bytes()
    assert j_rec.read_bytes() == full_rec.read_bytes()
