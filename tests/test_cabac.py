"""CABAC engine round-trip tests."""

import random

import numpy as np

from thevc.bitstream import InputBitstream, OutputBitstream
from thevc.cabac.contexts import NUM_CTX, make_context_states
from thevc.cabac.engine import BinDecoder, BinEncoder
from thevc.params import B_SLICE, I_SLICE, P_SLICE


def _roundtrip(seed, n_syms, qp=32, slice_type=I_SLICE):
    rng = random.Random(seed)
    # generate a symbol program: (kind, value, ctx/num)
    prog = []
    for _ in range(n_syms):
        kind = rng.choice(["ctx", "ctx", "ctx", "ep", "eps"])
        if kind == "ctx":
            prog.append(("ctx", rng.randint(0, 1), rng.randrange(NUM_CTX)))
        elif kind == "ep":
            prog.append(("ep", rng.randint(0, 1), None))
        else:
            n = rng.randint(1, 20)
            prog.append(("eps", rng.randrange(1 << n), n))

    out = OutputBitstream()
    enc = BinEncoder(out, make_context_states(slice_type, qp))
    for kind, val, aux in prog:
        if kind == "ctx":
            enc.encode_bin(val, aux)
        elif kind == "ep":
            enc.encode_bin_ep(val)
        else:
            enc.encode_bins_ep(val, aux)
    enc.encode_bin_trm(1)
    enc.finish()
    out.write(1, 1)
    out.write_align_zero()

    dec = BinDecoder(InputBitstream(out.get_bytes()),
                     make_context_states(slice_type, qp))
    for i, (kind, val, aux) in enumerate(prog):
        if kind == "ctx":
            got = dec.decode_bin(aux)
        elif kind == "ep":
            got = dec.decode_bin_ep()
        else:
            got = dec.decode_bins_ep(aux)
        assert got == val, (i, kind, val, got)
    assert dec.decode_bin_trm() == 1
    # context states must evolve identically on both sides
    np.testing.assert_array_equal(enc.ctx, dec.ctx)


def test_cabac_roundtrip_short():
    _roundtrip(1, 50)


def test_cabac_roundtrip_long():
    for seed in range(5):
        _roundtrip(seed + 10, 5000)


def test_cabac_roundtrip_slice_types_qps():
    for st in (B_SLICE, P_SLICE, I_SLICE):
        for qp in (0, 17, 32, 51):
            _roundtrip(100 + st * 52 + qp, 800, qp=qp, slice_type=st)


def test_cabac_all_mps_run():
    """Long MPS runs exercise the carry/renorm machinery."""
    out = OutputBitstream()
    ctx = make_context_states(I_SLICE, 32)
    enc = BinEncoder(out, ctx.copy())
    mps = [int(s & 1) for s in ctx]
    for i in range(3000):
        enc.encode_bin(mps[i % NUM_CTX], i % NUM_CTX)
        mps[i % NUM_CTX] = int(enc.ctx[i % NUM_CTX] & 1)
    enc.encode_bin_trm(1)
    enc.finish()
    out.write(1, 1)
    out.write_align_zero()

    dec = BinDecoder(InputBitstream(out.get_bytes()), ctx.copy())
    mps = [int(s & 1) for s in ctx]
    for i in range(3000):
        got = dec.decode_bin(i % NUM_CTX)
        assert got == mps[i % NUM_CTX]
        mps[i % NUM_CTX] = int(dec.ctx[i % NUM_CTX] & 1)
    assert dec.decode_bin_trm() == 1


def test_init_state_known_values():
    from thevc.cabac.tables import init_state
    # init value 154 (CNU) at any QP gives state 0/1 boundary region;
    # spot-check the formula against hand-computed values.
    # initValue=154: slope=(9)*5-45=0, offset=((154&15)<<3)-16=64 -> state 64 -> mps=1, state=(0<<1)+1=1
    assert init_state(32, 154) == 1
    # initValue=197, qp=32: slope=(12)*5-45=15, offset=((5)<<3)-16=24
    # init=min(max(1,(15*32>>4)+24),126)=54 -> mps=0 -> ((63-54)<<1)+0=18
    assert init_state(32, 197) == 18
