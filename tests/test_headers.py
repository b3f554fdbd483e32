"""Header parse/write parity against the HM oracle's streams."""

from thevc import headers, nal
from thevc.bitstream import InputBitstream
from thevc.digest import calc_md5
from thevc.io.yuv import YuvReader
from thevc.params import I_SLICE


def _units(stream):
    return list(nal.iter_annexb_nals(stream["bin"].read_bytes()))


def test_parameter_set_roundtrip(golden_intra_stream):
    """Parse the oracle's VPS/SPS/PPS and re-serialize byte-identically."""
    for u in _units(golden_intra_stream):
        bs = InputBitstream(u.rbsp)
        if u.nal_type == nal.NAL_UNIT_VPS:
            assert headers.write_vps(headers.parse_vps(bs)).get_bytes() == u.rbsp
        elif u.nal_type == nal.NAL_UNIT_SPS:
            sps = headers.parse_sps(bs)
            assert headers.write_sps(sps).get_bytes() == u.rbsp
            assert sps.pic_width_in_luma_samples == 416
            assert sps.pic_height_in_luma_samples == 240
            assert sps.max_cu_width == 64 and sps.max_cu_depth == 4
        elif u.nal_type == nal.NAL_UNIT_PPS:
            pps = headers.parse_pps(bs)
            assert headers.write_pps(pps).get_bytes() == u.rbsp


def test_slice_header_parse(golden_intra_stream):
    sps_map, pps_map = {}, {}
    slices = []
    prev_poc = 0
    for u in _units(golden_intra_stream):
        bs = InputBitstream(u.rbsp)
        if u.nal_type == nal.NAL_UNIT_SPS:
            sps = headers.parse_sps(bs)
            sps_map[sps.sps_id] = sps
        elif u.nal_type == nal.NAL_UNIT_PPS:
            pps = headers.parse_pps(bs)
            pps_map[pps.pps_id] = pps
        elif nal.is_slice_nal(u.nal_type):
            sh, _, _ = headers.parse_slice_header(
                bs, u.nal_type, u.temporal_id, sps_map, pps_map, prev_poc)
            prev_poc = sh.poc
            slices.append(sh)
    assert [s.poc for s in slices] == [0, 1]
    assert all(s.slice_type == I_SLICE for s in slices)
    assert all(s.slice_qp == 32 for s in slices)


def test_digest_sei_matches_recon(golden_intra_stream):
    """Recompute MD5 of the oracle recon; must equal the embedded SEI."""
    digests = []
    for u in _units(golden_intra_stream):
        if u.nal_type == nal.NAL_UNIT_SEI:
            for sei in headers.parse_sei_rbsp(u.rbsp):
                if sei["type"] == "picture_digest":
                    digests.append(sei["digest"])
    r = YuvReader(str(golden_intra_stream["rec"]), 416, 240)
    for frame_digest in digests:
        frame = r.read_frame()
        assert calc_md5(frame.planes(), 8) == list(frame_digest)


def test_sei_write_roundtrip(golden_intra_stream):
    for u in _units(golden_intra_stream):
        if u.nal_type == nal.NAL_UNIT_SEI:
            sei = headers.parse_sei_rbsp(u.rbsp)[0]
            out = headers.write_sei_picture_digest(
                sei["method"], [list(d) for d in sei["digest"]])
            assert out.get_bytes() == u.rbsp
