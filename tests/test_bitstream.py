"""Bitstream, Exp-Golomb, and NAL framing round-trip tests."""

import random

from thevc.bitstream import InputBitstream, OutputBitstream
from thevc import nal


def test_bit_roundtrip_random():
    rng = random.Random(7)
    fields = [(rng.randrange(1 << n), n) for n in
              (rng.randint(1, 32) for _ in range(2000))]
    out = OutputBitstream()
    for v, n in fields:
        out.write(v, n)
    out.write_align_zero()
    inp = InputBitstream(out.get_bytes())
    for v, n in fields:
        assert inp.read(n) == v


def test_ue_se_roundtrip():
    vals = list(range(0, 200)) + [2**10, 2**16 - 1, 2**20]
    out = OutputBitstream()
    for v in vals:
        out.write_ue(v)
    for v in vals:
        out.write_se(v - 100)
    out.write_rbsp_trailing_bits()
    inp = InputBitstream(out.get_bytes())
    for v in vals:
        assert inp.read_ue() == v
    for v in vals:
        assert inp.read_se() == v - 100


def test_ue_known_codes():
    # ue(0)='1', ue(1)='010', ue(2)='011', ue(3)='00100'
    out = OutputBitstream()
    for v in (0, 1, 2, 3):
        out.write_ue(v)
    # 1 010 011 00100 -> 1010 0110 0100 0000
    out.write_align_zero()
    assert out.get_bytes() == bytes([0b10100110, 0b01000000])


def test_substream_concat():
    a = OutputBitstream()
    a.write(0b101, 3)
    b = OutputBitstream()
    b.write(0xAB, 8)
    b.write(0b1, 1)
    a.add_substream(b)
    a.write_align_zero()
    inp = InputBitstream(a.get_bytes())
    assert inp.read(3) == 0b101
    assert inp.read(8) == 0xAB
    assert inp.read(1) == 1


def test_ebsp_roundtrip():
    payloads = [
        b"\x00\x00\x00\x00\x01\x02\x03",
        b"\x00\x00",
        b"\x00\x00\x03\x00\x00\x02",
        b"\xff" * 10,
        bytes(range(256)) + b"\x00\x00\x01" + b"\x00\x00\x00" + b"\x00",
    ]
    for p in payloads:
        e = nal.rbsp_to_ebsp(p)
        # no forbidden 00 00 {00,01,02} sequences remain (00 00 03 is the
        # escape itself and is legal when followed by 00-03)
        for i in range(len(e) - 2):
            assert not (e[i] == 0 and e[i + 1] == 0 and e[i + 2] <= 2), (p, e, i)
            if i + 3 < len(e) and e[i] == 0 and e[i + 1] == 0 and e[i + 2] == 3:
                assert e[i + 3] <= 3, (p, e, i)
        assert e[-1] != 0
        assert nal.ebsp_to_rbsp(e) == p


def test_annexb_roundtrip():
    units = [(nal.NAL_UNIT_VPS, 0, b"\x12\x34"),
             (nal.NAL_UNIT_SPS, 0, b"\x00\x00\x00\x01\x55"),
             (nal.NAL_UNIT_PPS, 0, b"\xaa"),
             (nal.NAL_UNIT_CODED_SLICE_IDR, 0, b"\x99" * 40),
             # NB: conforming RBSPs end in rbsp_trailing_bits, never a bare 00
             (nal.NAL_UNIT_CODED_SLICE, 2, b"\x00\x00\x02\x80")]
    stream, sizes = nal.write_annexb(units)
    assert sum(sizes) == len(stream)
    parsed = list(nal.iter_annexb_nals(stream))
    assert len(parsed) == len(units)
    for (t, tid, rbsp), u in zip(units, parsed):
        assert u.nal_type == t
        assert u.temporal_id == tid
        assert u.rbsp == rbsp


def test_parse_oracle_stream_nal_structure(golden_intra_stream):
    """The HM oracle's Annex-B stream parses into the expected NAL sequence."""
    data = golden_intra_stream["bin"].read_bytes()
    units = list(nal.iter_annexb_nals(data))
    types = [u.nal_type for u in units]
    # VPS, SPS, PPS, then per frame: SEI (digest) + slice
    assert types[0] == nal.NAL_UNIT_VPS
    assert types[1] == nal.NAL_UNIT_SPS
    assert types[2] == nal.NAL_UNIT_PPS
    assert nal.NAL_UNIT_SEI in types
    slice_count = sum(1 for t in types if nal.is_slice_nal(t))
    assert slice_count == golden_intra_stream["frames"]
