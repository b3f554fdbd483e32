"""Decoder conformance: bit-exact reconstruction of reference-encoder streams,
verified via the digest SEI (the reference's own conformance mechanism,
SURVEY.md section 4)."""

import subprocess

import numpy as np
import pytest

from thevc.utils.cfg import CFG_DIR
from thevc.decoder.top import Decoder
from thevc.io.yuv import YuvReader

from conftest import ORACLE_BIN, TESTDATA


def _encode(clip, out_bin, w=416, h=240, frames=1, extra=()):
    if not out_bin.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/encoder_intra_main.cfg",
             "-i", str(clip), "-wdt", str(w), "-hgt", str(h),
             "-f", str(frames), "-fr", "30", "-b", str(out_bin),
             "-o", "/dev/null", "--SEIpictureDigest=1", *extra],
            check=True, capture_output=True)
    return out_bin


def _decode_ok(path):
    pics = Decoder().decode_stream(path.read_bytes())
    assert pics, "no pictures decoded"
    for p in pics:
        assert p.digest_ok is True, f"digest mismatch at POC {p.poc}"
    return pics


def test_decode_golden_intra_stream(golden_intra_stream):
    pics = _decode_ok(golden_intra_stream["bin"])
    assert len(pics) == golden_intra_stream["frames"]
    # recon must match the encoder's recon output byte for byte
    r = YuvReader(str(golden_intra_stream["rec"]), 416, 240)
    for p in pics:
        ref = r.read_frame()
        for a, b in zip(p.frame.planes(), ref.planes()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("qp", [22, 32, 45, 51])
def test_decode_qp_sweep(oracle, test_clip, qp):
    out = _encode(test_clip, TESTDATA / f"conf_q{qp}.bin", extra=["-q", str(qp)])
    _decode_ok(out)


def test_decode_lossless(oracle, test_clip):
    out = _encode(test_clip, TESTDATA / "conf_lossless.bin",
                  extra=["--LosslessCuEnabled=1", "--TransquantBypassEnableFlag=1",
                         "--CUTransquantBypassFlagValue=1"])
    _decode_ok(out)


def test_decode_pcm(oracle, test_clip):
    out = _encode(test_clip, TESTDATA / "conf_pcm.bin",
                  extra=["--PCMEnabledFlag=1"])
    _decode_ok(out)


def test_decode_cu_dqp(oracle, test_clip):
    out = _encode(test_clip, TESTDATA / "conf_dqp.bin",
                  extra=["--MaxCuDQPDepth=1", "--MaxDeltaQP=1"])
    _decode_ok(out)


def test_decode_no_filters(oracle, test_clip):
    out = _encode(test_clip, TESTDATA / "conf_nofilt.bin",
                  extra=["--DeblockingFilterControlPresent=1",
                         "--LoopFilterDisable=1", "--SAO=0"])
    _decode_ok(out)


# ---------------------------------------------------------------------------
# Inter configurations (P/B slices, merge/AMVP/TMVP, MC, inter deblock BS)
# ---------------------------------------------------------------------------

from conftest import TESTDATA, oracle_encode_small


@pytest.mark.parametrize("cfg,name", [
    ("encoder_lowdelay_P_main.cfg", "ldp"),
    ("encoder_lowdelay_main.cfg", "ldb"),
    ("encoder_randomaccess_main.cfg", "ra"),
    ("encoder_randomaccess_he10.cfg", "ra10"),
])
def test_decode_inter_configs(oracle, test_clip_small, cfg, name):
    """Digest-exact decode of the reference encoder's inter configurations
    (reference test strategy: TDecGop digest check, SURVEY.md section 4)."""
    out = TESTDATA / f"inter_{name}.bin"
    if not out.exists():
        oracle_encode_small(cfg, test_clip_small, out)
    pics = _decode_ok(out)
    assert len(pics) == 9


# ---------------------------------------------------------------------------
# Frame partitioning: slices / dependent slices / tiles / WPP
# (reference section 2e; TDecSlice.cpp:93+ CTU order + CABAC state rules)
# ---------------------------------------------------------------------------

_PART_STREAMS = {
    # 2 slices per picture (SliceMode=1)
    "slices": (1, ["--SliceMode=1", "--SliceArgument=14"]),
    # 2x2 uniform tiles
    "tiles": (1, ["--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1",
                  "--NumTileRowsMinus1=1"]),
    # WaveFrontSynchro=1 (one substream per CTU row)
    "wpp": (1, ["--WaveFrontSynchro=1"]),
    # dependent slices (CABAC ctx carry-over)
    "dep": (1, ["--DependentSliceMode=1", "--DependentSliceArgument=14"]),
    # WPP + lowdelay_P inter
    "wppP": (0, ["--WaveFrontSynchro=1"]),
    # explicit-width tile columns + inter
    "tilesP": (0, ["--UniformSpacingIdc=0", "--NumTileColumnsMinus1=2",
                   "--ColumnWidthArray=2 3"]),
    # 3 slices + inter
    "slicesP": (0, ["--SliceMode=1", "--SliceArgument=10"]),
    # tiles + slices combined
    "ts": (1, ["--UniformSpacingIdc=1", "--NumTileColumnsMinus1=1",
               "--SliceMode=1", "--SliceArgument=10"]),
    # dependent slices + entropy sync (WPP-style row ctx)
    "depw": (1, ["--DependentSliceMode=1", "--DependentSliceArgument=7",
                 "--WaveFrontSynchro=1"]),
}


@pytest.mark.parametrize("name", sorted(_PART_STREAMS))
def test_decode_partitioned_streams(oracle, test_clip, name):
    """Digest-exact decode of multi-slice/tile/WPP/dependent-slice streams
    (reference section 2e; TDecSlice.cpp:93+ CTU order + CABAC state)."""
    intra, extra = _PART_STREAMS[name]
    out = TESTDATA / f"part_{name}.bin"
    if not out.exists():
        cfg = "encoder_intra_main.cfg" if intra else "encoder_lowdelay_P_main.cfg"
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/{cfg}",
             "-i", str(test_clip), "-wdt", "416", "-hgt", "240",
             "-f", "2" if intra else "4", "-fr", "30", "-b", str(out),
             "-o", "/dev/null", "--SEIpictureDigest=1", *extra],
            check=True, capture_output=True)
    _decode_ok(out)


# ---------------------------------------------------------------------------
# Weighted prediction (TComWeightPrediction.cpp:61-366)
# ---------------------------------------------------------------------------

def _make_fade_clip(path):
    """Luma/chroma fade so the reference encoder's WP analysis engages."""
    rng = np.random.RandomState(7)
    w, h, n = 176, 144, 9

    def smooth(a):
        out = a.astype(np.float32)
        hh, ww = out.shape
        for _ in range(2):
            p = np.pad(out, 2, mode="edge")
            out = sum(p[i:i + hh, j:j + ww]
                      for i in range(5) for j in range(5)) / 25
        return out

    y0 = smooth(rng.randint(0, 200, (h, w)))
    cb0 = smooth(rng.randint(80, 180, (h // 2, w // 2)))
    cr0 = smooth(rng.randint(80, 180, (h // 2, w // 2)))
    with open(path, "wb") as fh:
        for i in range(n):
            g, off = 1.0 - 0.08 * i, 5 * i
            fh.write(np.clip(y0 * g + off, 0, 255).astype(np.uint8).tobytes())
            fh.write(np.clip(cb0 * g + off / 2, 0, 255)
                     .astype(np.uint8).tobytes())
            fh.write(np.clip(cr0 * g + off / 2, 0, 255)
                     .astype(np.uint8).tobytes())


@pytest.mark.parametrize("cfg,opt,name", [
    ("encoder_lowdelay_P_main.cfg", "-wpP", "wpP"),
    ("encoder_lowdelay_main.cfg", "-wpB", "wpB"),
])
def test_decode_weighted_prediction(oracle, cfg, opt, name):
    """Digest-exact decode of explicitly weighted P/B streams on a fade."""
    clip = TESTDATA / "clip_fade_176x144.yuv"
    if not clip.exists():
        _make_fade_clip(clip)
    out = TESTDATA / f"wp_{name}.bin"
    if not out.exists():
        subprocess.run(
            [str(ORACLE_BIN / "TAppEncoder"),
             "-c", f"{CFG_DIR}/{cfg}",
             "-i", str(clip), "-wdt", "176", "-hgt", "144",
             "-f", "5", "-fr", "30", opt, "1", "-b", str(out),
             "-o", "/dev/null", "--SEIpictureDigest=1"],
            check=True, capture_output=True)
    _decode_ok(out)


def _write_custom_matrices(path):
    """An HM ScalingListFile with non-default matrices (exercises the SPS
    scaling-list syntax: DPCM coding + DC values + checkDefaultScalingList)."""
    from thevc.common import scaling as sc
    rng = np.random.RandomState(7)
    out = []
    for sid in range(4):
        for lid in range(sc.SCALING_LIST_NUM[sid]):
            n = min(64, sc.SCALING_LIST_SIZE[sid])
            out.append(sc._MATRIX_TYPE[sid][lid] + " =")
            vals = np.clip(16 + rng.randint(-6, 40, n), 1, 255)
            for i in range(0, n, 8):
                out.append(",".join(str(v) for v in vals[i:i + 8]) + ",")
            if sid > 1:
                out.append(sc._MATRIX_TYPE_DC[sid][lid] + " =")
                out.append(str(int(np.clip(16 + rng.randint(-6, 40),
                                           1, 255))) + ",")
    path.write_text("\n".join(out) + "\n")


def test_decode_scaling_list_default(oracle, test_clip):
    """--ScalingList=1: default quantization matrices, intra."""
    out = _encode(test_clip, TESTDATA / "intra_sl1.bin", frames=2,
                  extra=["--ScalingList=1"])
    _decode_ok(out)


def test_decode_scaling_list_default_inter(oracle):
    """--ScalingList=1 on a lowdelay B stream (inter dequant incl. the
    32x32 list-3-onto-list-1 aliasing, TComTrQuant.cpp:3038)."""
    from conftest import oracle_encode_small
    clip = TESTDATA / "clip_fade_176x144.yuv"
    if not clip.exists():
        _make_fade_clip(clip)
    out = TESTDATA / "ldb_sl1.bin"
    if not out.exists():
        oracle_encode_small("encoder_lowdelay_main.cfg", clip, out,
                            frames=5, extra=["-q", "22", "--ScalingList=1"])
    _decode_ok(out)


def test_decode_scaling_list_custom(oracle, test_clip, tmp_path):
    """--ScalingList=2 with a custom matrix file: the SPS carries the full
    scaling-list data (parse + dequant tables from transmitted matrices)."""
    mat = tmp_path / "mat.txt"
    _write_custom_matrices(mat)
    out = tmp_path / "intra_sl2.bin"
    _encode(test_clip, out, frames=2,
            extra=["--ScalingList=2", f"--ScalingListFile={mat}"])
    _decode_ok(out)
