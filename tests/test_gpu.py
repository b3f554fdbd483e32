"""Device code compiled for the GPU, bit-exact against the numpy
reference.  These need the card: they skip on CPU hosts and run on the
GPU through `python chip_smoke.py` (phase 2).  Self-contained, so that
chip_smoke.py can run this file alone."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("size,use_dst,bit_inc", [
    (4, False, 0), (4, True, 0), (8, False, 0), (16, False, 0),
    (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2),
])
def test_gpu_residual_core(gpu, size, use_dst, bit_inc):
    """The residual core the decoder runs on the card."""
    import jax
    from thevc.ops import jx
    from thevc.ops import transforms as tops
    rng = np.random.RandomState(size + bit_inc)
    q = rng.randint(-32768, 32768, (1001, size, size)).astype(np.int16)
    qp = rng.randint(0, 64, 1001).astype(np.int32)
    with jax.default_device(gpu):
        got = np.asarray(jx.residual_pipeline(q, qp, use_dst, bit_inc))
    ref = tops.inverse_transform(
        tops.dequant(q.astype(np.int32), qp, bit_inc), use_dst,
        bit_inc).astype(np.int16)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("size,use_dst", [(4, False), (4, True), (8, False),
                                          (16, False), (32, False)])
def test_gpu_transforms(gpu, size, use_dst):
    """forward/inverse transform on the card: int32 dots stay exact."""
    import jax
    from thevc.ops import jx
    from thevc.ops import transforms as tops
    rng = np.random.RandomState(size)
    resi = rng.randint(-1023, 1024, (777, size, size)).astype(np.int32)
    coeff = rng.randint(-32768, 32768, (777, size, size)).astype(np.int32)
    with jax.default_device(gpu):
        fwd = np.asarray(jx.forward_transform(resi, use_dst, 2))
        inv = np.asarray(jx.inverse_transform(coeff, use_dst, 2))
    assert np.array_equal(fwd, tops.forward_transform(resi, use_dst, 2))
    assert np.array_equal(inv, tops.inverse_transform(coeff, use_dst, 2))
