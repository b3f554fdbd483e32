"""JAX device ops must match the bit-exact numpy reference ops."""

import numpy as np
import pytest

from thevc.ops import transforms as tnp


@pytest.fixture(scope="module")
def jx():
    from thevc.ops import jx as _jx
    return _jx


@pytest.mark.parametrize("size", [4, 8, 16, 32])
@pytest.mark.parametrize("use_dst", [False, True])
def test_forward_inverse_parity(jx, size, use_dst):
    if use_dst and size != 4:
        pytest.skip("DST is 4x4 only")
    rng = np.random.RandomState(size)
    block = rng.randint(-255, 256, (32, size, size)).astype(np.int32)
    ref = tnp.forward_transform(block, use_dst)
    got = np.asarray(jx.forward_transform(block, use_dst))
    np.testing.assert_array_equal(ref, got)

    coeff = rng.randint(-1024, 1024, (32, size, size)).astype(np.int32)
    ref_i = tnp.inverse_transform(coeff, use_dst)
    got_i = np.asarray(jx.inverse_transform(coeff, use_dst))
    np.testing.assert_array_equal(ref_i, got_i)


@pytest.mark.parametrize("qp", [0, 17, 29, 43, 51])
def test_quant_dequant_parity(jx, qp):
    rng = np.random.RandomState(qp)
    coeff = rng.randint(-30000, 30000, (16, 8, 8)).astype(np.int32)
    ref = tnp.dequant(coeff, qp)
    got = np.asarray(jx.dequant(coeff, np.full(16, qp, np.int32)))
    np.testing.assert_array_equal(ref, got)

    level_ref, du_ref = tnp.quant(coeff, qp, True)
    level_got, du_got = jx.quant(coeff, np.full(16, qp, np.int32), True)
    np.testing.assert_array_equal(level_ref, np.asarray(level_got))
    np.testing.assert_array_equal(du_ref, np.asarray(du_got))


def test_transform_roundtrip_identity_at_low_qp(jx):
    """Encode->decode through the device pipeline approximates the input."""
    rng = np.random.RandomState(7)
    resi = rng.randint(-100, 100, (8, 8, 8)).astype(np.int32)
    qp = np.full(8, 4, np.int32)
    levels, _ = jx.transform_quant_pipeline(resi, qp)
    deq = jx.dequant(levels, qp)
    rec = np.asarray(jx.inverse_transform(deq))
    assert np.abs(rec - resi).max() <= 2


def test_graft_entry():
    import __graft_entry__ as g
    fn, args = g.entry()
    out = fn(*args)
    assert out.shape == args[0].shape
    import jax
    n = min(8, max(len(jax.devices()), len(jax.devices("cpu"))))
    g.dryrun_multichip(n)
