"""Decoder robustness: lost-picture concealment, random-access skip (-s),
BLA/TFD leading-picture skip, and long-term reference pictures.

Reference behavior: TDecTop.cpp (xCreateLostPicture :217,
isRandomAccessSkipPicture :738, isSkipPictureForBLA :715),
TComSlice.cpp (checkThatAllRefPicsAreAvailable :917, setRefPicList :402),
TEncGOP.cpp (arrangeLongtermPicturesInRPS :1849),
TEncCavlc.cpp:646-682 / TDecCAVLC.cpp:975-1025 (long-term slice syntax).
"""

import numpy as np
import pytest

from conftest import TESTDATA, oracle_encode_small

from thevc import headers, nal
from thevc.bitstream import InputBitstream
from thevc.decoder.top import Decoder
from thevc.decoder.refpic import (
    Dpb, build_ref_lists, check_all_ref_pics_available)
from thevc.encoder.top import arrange_longterm_pictures_in_rps
from thevc.params import ReferencePictureSet, SliceHeader


def _rebuild_stream(units):
    data, _ = nal.write_annexb(
        [(u.nal_type, u.temporal_id, u.rbsp) for u in units])
    return data


# ---------------------------------------------------------------------------
# Lost-picture concealment
# ---------------------------------------------------------------------------

def test_lost_picture_concealment(oracle, test_clip_small, capsys):
    """Dropping POC 3's slice NAL must insert a concealed copy of the
    closest DPB picture (POC 2) instead of crashing (TDecTop.cpp:217)."""
    src = TESTDATA / "inter_ldp.bin"
    if not src.exists():
        oracle_encode_small("encoder_lowdelay_P_main.cfg",
                            test_clip_small, src)
    units = list(nal.iter_annexb_nals(src.read_bytes()))
    kept, n_slice = [], 0
    for u in units:
        if nal.is_slice_nal(u.nal_type):
            n_slice += 1
            if n_slice == 4:      # LDP decode order == POC order: POC 3
                continue
        kept.append(u)
    dec = Decoder()
    pics = dec.decode_stream(_rebuild_stream(kept))
    out = capsys.readouterr().out
    assert "inserting lost poc : 3" in out
    assert [p.poc for p in pics] == list(range(9))
    concealed = next(p for p in pics if p.poc == 3)
    poc2 = next(p for p in pics if p.poc == 2)
    assert np.array_equal(concealed.frame.y, poc2.frame.y)
    # pictures decoded before the loss are still digest-exact
    assert all(p.digest_ok for p in pics if p.poc < 3)


# ---------------------------------------------------------------------------
# Random-access skip (-s)
# ---------------------------------------------------------------------------

def test_skip_frames_non_rap_discard(golden_intra_stream):
    """-s 1 on a stream whose later pictures are not random-access points
    discards everything with a warning (TDecTop.cpp:760-768)."""
    data = golden_intra_stream["bin"].read_bytes()
    pics = Decoder(skip_frames=1).decode_stream(data)
    assert pics == []


def test_skip_frames_to_cra(oracle, test_clip_small):
    """-s 9 on the 17-frame RA stream lands on the mid-stream CRA: POC 16
    decodes, its TFD leading pictures (POC 9-15) are dropped
    (isRandomAccessSkipPicture, TDecTop.cpp:738)."""
    src = _ra17_stream(oracle, test_clip_small)
    pics = Decoder(skip_frames=9).decode_stream(src.read_bytes())
    assert [p.poc for p in pics] == [16]
    assert all(p.digest_ok for p in pics)


# ---------------------------------------------------------------------------
# BLA / TFD leading-picture skip
# ---------------------------------------------------------------------------

def _ra17_stream(oracle, test_clip_small):
    """17-frame random-access stream with a mid-stream CRA at POC 16 and
    TFD leading pictures (POCs 9-15)."""
    clip = test_clip_small.parent / "clip_176x144_17f.yuv"
    if not clip.exists():
        import subprocess
        subprocess.run(
            ["python", str(TESTDATA.parent / "tools" / "make_test_clip.py"),
             str(clip), "--width", "176", "--height", "144",
             "--frames", "17"], check=True)
    src = TESTDATA / "inter_ra17.bin"
    if not src.exists():
        oracle_encode_small("encoder_randomaccess_main.cfg", clip, src,
                            frames=17, extra=("--IntraPeriod=16",))
    return src


def test_bla_tfd_skip(oracle, test_clip_small):
    """Rewriting the mid-stream CRA as BLA must drop its TFD leading
    pictures (POCs 9-15) while decoding everything else
    (isSkipPictureForBLA, TDecTop.cpp:715)."""
    src = _ra17_stream(oracle, test_clip_small)
    units = []
    for u in nal.iter_annexb_nals(src.read_bytes()):
        if u.nal_type == nal.NAL_UNIT_CODED_SLICE_CRA:
            u = nal.NalUnit(nal.NAL_UNIT_CODED_SLICE_BLA,
                            u.temporal_id, u.rbsp)
        units.append(u)
    pics = Decoder().decode_stream(_rebuild_stream(units))
    assert [p.poc for p in pics] == [0, 1, 2, 3, 4, 5, 6, 7, 8, 16]
    # non-leading pictures are bit-exact (BLA zeroes the RPS, so POC 16
    # itself is intra and unaffected)
    assert all(p.digest_ok for p in pics)


# ---------------------------------------------------------------------------
# Long-term reference pictures
# ---------------------------------------------------------------------------

class _FakePic:
    def __init__(self, poc):
        self.poc = poc
        self.referenced = True
        self.is_long_term = False
        self.is_used_as_long_term = False
        self.check_lt_msb = False


def _lt_rps(cur_poc, st_deltas, lt_pocs):
    rps = ReferencePictureSet()
    rps.num_negative_pics = len(st_deltas)
    rps.delta_poc = list(st_deltas) + [p - cur_poc for p in lt_pocs]
    rps.used = [True] * (len(st_deltas) + len(lt_pocs))
    rps.num_longterm_pics = len(lt_pocs)
    rps.poc = [0] * len(st_deltas) + list(lt_pocs)
    rps.check_lt_msb = [False] * (len(st_deltas) + len(lt_pocs))
    return rps


def test_longterm_ref_list_construction():
    """setRefPicList with one LT entry: LT picture lands after the short
    terms and is flagged long-term (TComSlice.cpp:402-470)."""
    dpb = Dpb()
    for poc in (0, 7):
        dpb.add(_FakePic(poc))
    sh = SliceHeader()
    sh.poc = 8
    sh.slice_type = 1  # P
    sh.num_ref_idx = [2, 0]
    sh.ref_pic_list_modification_flag = [False, False]
    sh.rps = _lt_rps(8, [-1], [0])
    l0, l1 = build_ref_lists(sh, dpb, bits_for_poc=8)
    assert [p.poc for p in l0] == [7, 0]
    assert not l0[0].is_long_term and l0[1].is_long_term
    assert l0[1].is_used_as_long_term

    # checkThatAllRefPicsAreAvailable: everything present -> 0
    assert check_all_ref_pics_available(sh, dpb, -1, 8) == 0
    # remove the LT picture -> lostPoc+1
    dpb.pics = [p for p in dpb.pics if p.poc != 0]
    sh2 = SliceHeader()
    sh2.poc = 8
    sh2.rps = _lt_rps(8, [-1], [0])
    assert check_all_ref_pics_available(sh2, dpb, -1, 8) == 0 + 1


def test_longterm_slice_header_roundtrip(oracle, test_clip_small):
    """arrange + write + parse of a P-slice header carrying one long-term
    entry reproduces the LT POCs and used flags."""
    src = TESTDATA / "inter_ldp.bin"
    if not src.exists():
        oracle_encode_small("encoder_lowdelay_P_main.cfg",
                            test_clip_small, src)
    sps_map, pps_map = {}, {}
    sh = sps = pps = None
    prev_poc = 0
    for u in nal.iter_annexb_nals(src.read_bytes()):
        bs = InputBitstream(u.rbsp)
        if u.nal_type == nal.NAL_UNIT_SPS:
            s = headers.parse_sps(bs)
            sps_map[s.sps_id] = s
        elif u.nal_type == nal.NAL_UNIT_PPS:
            p = headers.parse_pps(bs)
            pps_map[p.pps_id] = p
        elif nal.is_slice_nal(u.nal_type) and u.nal_type != \
                nal.NAL_UNIT_CODED_SLICE_IDR:
            sh, sps, pps = headers.parse_slice_header(
                bs, u.nal_type, u.temporal_id, sps_map, pps_map, prev_poc)
            if sh.poc >= 4:
                break
            prev_poc = sh.poc
    assert sh is not None and sh.poc >= 4

    sps.long_term_refs_present = True
    rps = sh.rps
    # graft two LT entries (POCs 0 and 1) onto the parsed short-term RPS
    n_st = rps.num_negative_pics + rps.num_positive_pics
    rps.delta_poc = rps.delta_poc[:n_st] + [0 - sh.poc, 1 - sh.poc]
    rps.used = rps.used[:n_st] + [True, False]
    rps.poc = [0] * n_st + [0, 1]
    rps.num_longterm_pics = 2
    rps.check_lt_msb = [False] * (n_st + 2)
    # re-express the inter-RPS prediction index relative to the slice-header
    # position (delta_idx_minus1 is position-relative, TDecCAVLC.cpp:938)
    if rps.inter_rps_prediction:
        ref_idx = sh.rps_idx - 1 - rps.delta_ridx_minus1
        rps.delta_ridx_minus1 = len(sps.rps_list) - 1 - ref_idx
    sh.rps_idx = -1   # force explicit in-header RPS

    dpb = Dpb()
    for poc in range(sh.poc):
        dpb.add(_FakePic(poc))
    arrange_longterm_pictures_in_rps(sh, sps, dpb)

    out = headers.write_slice_header(sh, sps, pps)
    out.write_align_one()
    sh2, _, _ = headers.parse_slice_header(
        InputBitstream(out.get_bytes()), sh.nal_unit_type, sh.temporal_id,
        sps_map, pps_map, prev_poc)
    rps2 = sh2.rps
    assert rps2.num_longterm_pics == 2
    n_st2 = rps2.num_negative_pics + rps2.num_positive_pics
    assert n_st2 == n_st
    got = sorted((rps2.poc[i], rps2.used[i])
                 for i in range(n_st2, n_st2 + 2))
    assert got == [(0, True), (1, False)]


def test_parallel_all_intra_decode(golden_intra_stream, oracle, test_clip,
                                   monkeypatch):
    """Picture-parallel all-intra decode path produces identical output to
    the serial decoder (incl. multi-slice pictures grouped by
    first_slice_in_pic_flag)."""
    import os
    import numpy as np
    streams = [golden_intra_stream["bin"]]
    multi = TESTDATA / "part_slices.bin"   # 2 slices/picture, intra
    if multi.exists():
        streams.append(multi)
    for path in streams:
        data = path.read_bytes()
        monkeypatch.setattr(os, "cpu_count", lambda: 4)
        par = Decoder().decode_stream(data)
        monkeypatch.setattr(os, "cpu_count", lambda: 1)
        ser = Decoder().decode_stream(data)
        assert [p.poc for p in par] == [p.poc for p in ser]
        assert all(p.digest_ok for p in par)
        for a, b in zip(par, ser):
            assert np.array_equal(a.frame.y, b.frame.y)
            assert np.array_equal(a.frame.cb, b.frame.cb)
            assert np.array_equal(a.frame.cr, b.frame.cr)


# ---------------------------------------------------------------------------
# Corruption fuzzing: no crash, ever
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_corrupted_stream_fuzz(golden_intra_stream):
    """Bit-flipped and truncated streams must never crash the decoder
    (native CABAC parse included) — they either decode with concealment
    or raise a clean Python exception.  The reference tolerates garbage
    similarly (TDecTop/TDecCavlc error paths); the hard requirement here
    is memory safety of the native parse core (BsEngine overflow
    tracking) under arbitrary input."""
    _fuzz_stream(bytearray(golden_intra_stream["bin"].read_bytes()), 40)


@pytest.mark.slow
def test_corrupted_inter_stream_fuzz(oracle, test_clip_small):
    """Same gate on a hierarchical-B stream: corrupt motion fields and
    reference indices must not drive the native MC/recon core out of
    bounds (padded reference margins + clean error paths)."""
    src = TESTDATA / "inter_ra.bin"
    if not src.exists():
        oracle_encode_small("encoder_randomaccess_main.cfg",
                            test_clip_small, src, frames=9)
    _fuzz_stream(bytearray(src.read_bytes()), 24)


def _fuzz_stream(data: bytearray, trials: int) -> None:
    rng = np.random.RandomState(1234)
    n_ok = 0
    for trial in range(trials):
        buf = bytearray(data)
        kind = trial % 3
        if kind == 0:                       # single byte flips
            for _ in range(rng.randint(1, 6)):
                i = rng.randint(0, len(buf))
                buf[i] ^= 1 << rng.randint(0, 8)
        elif kind == 1:                     # truncation
            buf = buf[: rng.randint(1, len(buf))]
        else:                               # flip + truncate
            i = rng.randint(0, len(buf))
            buf[i] ^= 0xFF
            buf = buf[: rng.randint(max(1, i), len(buf) + 1)]
        try:
            pics = Decoder().decode_stream(bytes(buf))
            n_ok += 1
            assert isinstance(pics, list)
        except Exception:
            pass                            # clean failure is acceptable
    # sanity: the harness isn't trivially rejecting everything
    assert n_ok > 0
