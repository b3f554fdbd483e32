"""Fast-RD intra decisions: the decoupled two-pass device encoder.

This is the SURVEY.md §7 design move the exact path cannot make: instead of
HM's sequential best-vs-temp RD walk (TEncCu.cpp:386, where every candidate
prediction depends on previously reconstructed neighbors), the CU quadtree,
per-PU luma modes and per-CU chroma modes are decided OPEN-LOOP — reference
samples come from the *source* picture, so every block of the frame is
independent and the whole decision problem becomes a handful of batched
device kernels:

  1. per size class (4..64): gather reference lines for every block of the
     frame at once, run all 35 intra predictions (same integer math as
     TComPrediction.cpp xPredIntraAng :190 / xPredIntraPlanar :689 /
     xDCPredFiltering :1010), Hadamard-SATD them against the source
     (TComRdCost::xCalcHADs8x8 :1778), and add the CABAC mode-bit estimate
     (TEncSearch xModeBitsIntra :5889 — MPM classes approximated from the
     SATD-best modes of the open-loop neighbors);
  2. for each block's top-K modes: forward transform + quant
     (TComTrQuant.cpp :417, :1102) + inverse recon, giving an RD estimate
     dist + lambda*bits with a coefficient-bit model; the winner's RD
     feeds the tree decision;
  3. per size class >= 8: the 5-candidate chroma mode RD
     (TEncSearch::estIntraPredChromaQT :2806 — planar/ver/hor/dc with the
     luma-duplicate slot replaced by mode 34, plus DM) batched the same
     way, with open-loop chroma references;
  4. a bottom-up quadtree DP (on device) picks leaf-vs-split per CU from
     the combined luma+chroma RD (the batched equivalent of TEncCu's split
     compare at :829-975), including the 8x8-vs-NxN partition choice, and
     expands the tree into flat per-4x4-unit decision maps.

Everything above runs as ONE jitted launch per frame on the GPU; the
only device->host fetch is the packed int8 decision map (4 planes of
[H/4, W/4] — ~0.5 MB at 1080p).

The maps feed the native apply pass (codec_core.cpp enc_set_fd): the CTU
loop predicts from real reconstructed neighbors, transforms/quantizes with
RDOQ, and runs both CABAC passes for ONE luma mode at ONE depth with a
FIXED TU split and ONE chroma mode — so the emitted stream is fully
conformant (HM-decodable, digest-verified) while the dominant search FLOPs
run on the device.

Decision quality is not bit-matched to HM (open-loop references, frozen
mode-bit contexts, modelled coefficient bits); measured cost on synthetic
content is a few percent bitrate at equal PSNR — see tests/test_fast_rd.py
and the bench extra fields.  FastRD=0 (default) keeps the byte-exact path.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..ops.intra import (ANG_TABLE, INV_ANG_TABLE, INTRA_FILTER_THRESH,
                         DC_IDX, HOR_IDX, PLANAR_IDX, VER_IDX)

SIZES = (4, 8, 16, 32, 64)
DM_CHROMA_IDX = 36


# ---------------------------------------------------------------------------
# static per-(mode,size) index plans for batched angular prediction
# ---------------------------------------------------------------------------

def _angular_plan(size: int, mode: int):
    """Precompute the static gather plan for one angular mode.

    Returns (side_idx, n_main, off, delta_int, delta_frac, mode_hor):
    refmain = concat(side[side_idx], main[:n_main]); prediction row k
    (0-based) reads refmain[off + l + delta_int[k] + 1] lerped by
    delta_frac[k] (xPredIntraAng, TComPrediction.cpp:190).
    """
    mode_hor = mode < 18
    ipa = -(mode - HOR_IDX) if mode_hor else (mode - VER_IDX)
    abs_ang = int(ANG_TABLE[abs(ipa)])
    inv_angle = int(INV_ANG_TABLE[abs(ipa)])
    angle = -abs_ang if ipa < 0 else abs_ang

    if angle < 0:
        ext = (size * angle) >> 5            # negative
        side_idx = []
        inv_sum = 128
        for k in range(-1, ext, -1):
            inv_sum += inv_angle
            side_idx.append(inv_sum >> 8)
        side_idx.reverse()                   # refmain[ext+1..-1]
        n_main = size + 1                    # refmain[0..size]
        # the list holds refMain[ext+1..size] (refMain[ext] is never
        # read: the shallowest delta is one full step), so refMain[m]
        # sits at index m - ext - 1
        off = -ext - 1
    else:
        side_idx = []
        n_main = 2 * size + 1
        off = 0

    k = np.arange(1, size + 1, dtype=np.int64)
    delta = k * angle
    return (np.asarray(side_idx, np.int32), n_main, off,
            (delta >> 5).astype(np.int32), (delta & 31).astype(np.int32),
            mode_hor, angle)


_unified_plan_cache = {}


def _unified_plan(size: int, luma: bool):
    """Static gather plan for ALL 33 angular modes at once.

    The canonical reference array per block is c = concat(rl, ra[1:])
    (length L = 4s+1; index 0 is the shared corner), doubled as
    C = concat(c, c_filtered) so the per-mode [1 2 1]-filter choice
    (TComPrediction.cpp:385, INTRA_FILTER_THRESH) is just an index
    offset (chroma never filters: the caller passes the raw line twice).
    Returns (idx_a, idx_b, frac): three [33, s, s] int32 maps
    so every angular prediction (xPredIntraAng, TComPrediction.cpp:190)
    becomes ONE static gather + lerp — one XLA kernel instead of 33
    separately-compiled graphs (cold 1080p compile: minutes -> seconds).
    Horizontal modes bake the output transpose into the maps.
    """
    plan = _unified_plan_cache.get((size, luma))
    if plan is not None:
        return plan
    s = size
    L = 4 * s + 1
    log2 = s.bit_length() - 1

    def cidx(is_ra: bool, j: int) -> int:
        # index of ra[j]/rl[j] inside c = concat(rl, ra[1:])
        if j == 0:
            return 0
        return 2 * s + j if is_ra else j

    idx_a = np.zeros((33, s, s), np.int64)
    idx_b = np.zeros((33, s, s), np.int64)
    frac = np.zeros((33, s, s), np.int64)
    for mode in range(2, 35):
        side_idx, n_main, off, dint, dfrac, mode_hor, angle = \
            _angular_plan(s, mode)
        main_is_ra = not mode_hor
        refidx = [cidx(not main_is_ra, int(j)) for j in side_idx] + \
                 [cidx(main_is_ra, j) for j in range(n_main)]
        refidx = np.asarray(refidx, np.int64)
        ll = np.arange(s, dtype=np.int64)
        p = off + ll[None, :] + dint[:, None].astype(np.int64) + 1  # [s, s]
        ia = refidx[p]
        # b is only read where frac != 0; p+1 can run one past the end on
        # the frac==0 rows of mode 2/34-style full-stride angles — clamp
        ib = refidx[np.minimum(p + 1, len(refidx) - 1)]
        fr = np.broadcast_to(dfrac[:, None].astype(np.int64), (s, s))
        if mode_hor:
            ia, ib, fr = ia.T, ib.T, fr.T
        diff = min(abs(mode - HOR_IDX), abs(mode - VER_IDX))
        if luma and diff > INTRA_FILTER_THRESH[log2]:
            ia = ia + L
            ib = ib + L
        m = mode - 2
        idx_a[m], idx_b[m], frac[m] = ia, ib, fr
    plan = (idx_a.astype(np.int32), idx_b.astype(np.int32),
            frac.astype(np.int32))
    _unified_plan_cache[(size, luma)] = plan
    return plan


def _predict_all_angular(ra, rl, ra_f, rl_f, size: int, max_val: int,
                         luma: bool = True):
    """All 33 angular modes for a block batch in one gather:
    [N, 2s+1] x4 -> [N, 33, s, s] (modes 2..34 in order).  For chroma
    (luma=False) the refs are never filtered and the mode 10/26 edge
    boundary filter is skipped (TComPrediction.cpp:268 bLuma gate)."""
    import jax.numpy as jnp

    idx_a, idx_b, frac = _unified_plan(size, luma)
    if luma:
        c = jnp.concatenate([rl, ra[:, 1:], rl_f, ra_f[:, 1:]], axis=1)
    else:
        c = jnp.concatenate([rl, ra[:, 1:]], axis=1)
    a = c[:, idx_a]
    b = c[:, idx_b]
    f = jnp.asarray(frac)
    pred = ((32 - f) * a + f * b + 16) >> 5     # f==0 reduces to a exactly

    if not luma:
        return pred
    s = size
    # pure-copy modes get the edge boundary filter (xPredIntraAng :268):
    # vertical (26) on its first column from the left deltas, horizontal
    # (10, transposed) on its first row from the top deltas
    d26 = (rl[:, 1:s + 1] - rl[:, 0:1]) >> 1
    pred = pred.at[:, 26 - 2, :, 0].set(
        jnp.clip(pred[:, 26 - 2, :, 0] + d26, 0, max_val))
    d10 = (ra[:, 1:s + 1] - ra[:, 0:1]) >> 1
    pred = pred.at[:, 10 - 2, 0, :].set(
        jnp.clip(pred[:, 10 - 2, 0, :] + d10, 0, max_val))
    return pred


def _predict_mode(ra, rl, size: int, mode: int, max_val: int,
                  luma: bool = True):
    """One intra mode for a whole block batch: ra/rl [N, 2s+1] -> [N, s, s].

    Integer-exact mirror of ops.intra.predict.
    """
    import jax.numpy as jnp

    n = ra.shape[0]
    if mode == PLANAR_IDX:
        log2 = size.bit_length() - 1
        top = ra[:, 1:size + 2]
        left = rl[:, 1:size + 2]
        bl = left[:, size][:, None]
        tr = top[:, size][:, None]
        bottom = bl - top[:, :size]
        right = tr - left[:, :size]
        kk = jnp.arange(1, size + 1, dtype=jnp.int32)
        hor = ((left[:, :size, None] << log2) + size
               + kk[None, None, :] * right[:, :size, None])
        ver = ((top[:, None, :size] << log2)
               + kk[None, :, None] * bottom[:, None, :size])
        return (hor + ver) >> (log2 + 1)

    if mode == DC_IDX:
        s_sum = (ra[:, 1:size + 1].sum(axis=1)
                 + rl[:, 1:size + 1].sum(axis=1))
        dc = (s_sum + size) // (2 * size)
        pred = jnp.broadcast_to(dc[:, None, None], (n, size, size))
        if not luma:
            return pred
        # xDCPredFiltering (luma only)
        top = ra[:, 1:size + 1]
        left = rl[:, 1:size + 1]
        row0 = (top + 3 * pred[:, 0, :] + 2) >> 2
        col0 = (left + 3 * pred[:, :, 0] + 2) >> 2
        c00 = (top[:, 0] + left[:, 0] + 2 * pred[:, 0, 0] + 2) >> 2
        pred = pred.at[:, 0, :].set(row0)
        pred = pred.at[:, :, 0].set(col0)
        pred = pred.at[:, 0, 0].set(c00)
        return pred

    side_idx, n_main, off, dint, dfrac, mode_hor, angle = \
        _angular_plan(size, mode)
    main, side = (rl, ra) if mode_hor else (ra, rl)
    if side_idx.size:
        rm = jnp.concatenate([side[:, side_idx], main[:, :n_main]], axis=1)
    else:
        rm = main[:, :n_main]

    if angle == 0:
        row = rm[:, off + 1: off + 1 + size]
        pred = jnp.broadcast_to(row[:, None, :], (n, size, size))
        if luma:
            delta = (side[:, 1:size + 1] - side[:, 0:1]) >> 1
            col0 = jnp.clip(pred[:, :, 0] + delta, 0, max_val)
            pred = pred.at[:, :, 0].set(col0)
    else:
        ll = np.arange(size, dtype=np.int32)
        idx = off + ll[None, :] + dint[:, None] + 1      # [s, s] static
        a = rm[:, idx]
        b = rm[:, idx + 1]
        f = jnp.asarray(dfrac[:, None], jnp.int32)
        pred = jnp.where(f != 0, ((32 - f) * a + f * b + 16) >> 5, a)
    if mode_hor:
        pred = jnp.swapaxes(pred, -1, -2)
    return pred


def _satd(org, pred, size: int, bit_inc: int):
    """HM SATD over a block batch: [N,s,s] vs [N,s,s] -> [N] int32
    (TComRdCost calcHAD: 8x8 Hadamard when divisible by 8, else 4x4)."""
    import jax.numpy as jnp

    return _satd_d(org.astype(jnp.int32) - pred.astype(jnp.int32),
                   size, bit_inc)


def _satd_d(d, size: int, bit_inc: int):
    import jax.numpy as jnp
    from ..ops.jx import _H4, _H8, _int_dot

    n = d.shape[0]
    if size % 8 == 0:
        h = jnp.asarray(_H8, jnp.int32)
        blocks = (d.reshape(n, size // 8, 8, size // 8, 8)
                  .transpose(0, 1, 3, 2, 4).reshape(n, -1, 8, 8))
        t1 = _int_dot("ij,nbjk->nbik", h, blocks)
        hm = _int_dot("kl,nbik->nbil", h, t1)
        sads = (jnp.sum(jnp.abs(hm), axis=(2, 3)) + 2) >> 2
    else:
        h = jnp.asarray(_H4, jnp.int32)
        blocks = (d.reshape(n, size // 4, 4, size // 4, 4)
                  .transpose(0, 1, 3, 2, 4).reshape(n, -1, 4, 4))
        t1 = _int_dot("ij,nbjk->nbik", h, blocks)
        hm = _int_dot("kl,nbik->nbil", h, t1)
        sads = (jnp.sum(jnp.abs(hm), axis=(2, 3)) + 1) >> 1
    return sads.sum(axis=1) >> bit_inc


def _mpm_vec(left, above):
    """Vectorized getIntraDirLumaPredictor (TComDataCU.cpp:1928)."""
    import jax.numpy as jnp

    same = left == above
    big = left > 1
    m0_same = jnp.where(big, left, PLANAR_IDX)
    m1_same = jnp.where(big, ((left + 29) % 32) + 2, DC_IDX)
    m2_same = jnp.where(big, ((left - 1) % 32) + 2, VER_IDX)
    both_nz = (left != 0) & (above != 0)
    third = jnp.where(both_nz, PLANAR_IDX,
                      jnp.where(left + above < 2, VER_IDX, DC_IDX))
    m0 = jnp.where(same, m0_same, left)
    m1 = jnp.where(same, m1_same, above)
    m2 = jnp.where(same, m2_same, third)
    return m0, m1, m2


def _coeff_bits_est(levels, size: int):
    """Coefficient-bit model in whole bits (float32): sig flag + unary/Rice
    level cost per nonzero, per-coded-subblock overhead, last-position.
    A coarse stand-in for the exact TEncSbac::codeCoeffNxN accounting —
    only decision ranking matters here."""
    import jax.numpy as jnp

    absl = jnp.abs(levels).astype(jnp.float32)
    nz = absl > 0
    level_bits = jnp.where(nz, 1.7 + 2.0 * jnp.log2(absl + 1.0), 0.0)
    bits = level_bits.sum(axis=(-2, -1))
    if size > 4:
        cg = nz.reshape(nz.shape[0], size // 4, 4, size // 4, 4)
        cg_any = cg.any(axis=(2, 4))
        bits = bits + 1.5 * cg_any.sum(axis=(1, 2)).astype(jnp.float32)
    any_nz = nz.any(axis=(-2, -1))
    log2 = size.bit_length() - 1
    bits = jnp.where(any_nz, bits + 2.0 * log2 + 1.0, 0.5)
    return bits


def _tq_rd(org, pred, size: int, qp_scaled, bit_inc: int, max_val: int,
           is_intra: bool = True):
    """Forward T + quant + recon RD for one prediction per block:
    [N,s,s] -> (dist [N] int32, bits [N] float32).  size 64 evaluates the
    four 32x32 quadrants (max TU is 32); size -32 evaluates a 32-sized
    block as 16x16 quadrants (the chroma TU grid of a 64 CU)."""
    import jax.numpy as jnp
    from ..ops import jx

    n = org.shape[0]
    resi = org.astype(jnp.int32) - pred.astype(jnp.int32)
    if size in (64, -32):
        s, t = (64, 32) if size == 64 else (32, 16)
        h = s // t
        resi = (resi.reshape(n, h, t, h, t).transpose(0, 1, 3, 2, 4)
                .reshape(h * h * n, t, t))
        porg = (org.astype(jnp.int32).reshape(n, h, t, h, t)
                .transpose(0, 1, 3, 2, 4).reshape(h * h * n, t, t))
        ppred = (pred.astype(jnp.int32).reshape(n, h, t, h, t)
                 .transpose(0, 1, 3, 2, 4).reshape(h * h * n, t, t))
        tsize = t
        nq = h * h
    else:
        porg, ppred, tsize, nq = org.astype(jnp.int32), pred, size, 1
    if qp_scaled.ndim:                       # per-block QP, tiled over quads
        qp = jnp.repeat(qp_scaled.astype(jnp.int32), nq) if nq > 1 \
            else qp_scaled.astype(jnp.int32)
    else:
        qp = jnp.full((resi.shape[0],), qp_scaled, jnp.int32)
    use_dst = tsize == 4 and is_intra
    coeff = jx.forward_transform(resi, use_dst, bit_inc)
    levels, _ = jx.quant(coeff, qp, is_intra, bit_inc)
    bits = _coeff_bits_est(levels, tsize)
    recon = jx.tu_recon_pipeline(ppred, levels, qp, use_dst, bit_inc,
                                 max_val)
    d = porg - recon.astype(jnp.int32)
    dist = (d * d).sum(axis=(-2, -1)) >> (2 * bit_inc)
    if nq > 1:
        dist = dist.reshape(n, nq).sum(axis=1)
        bits = bits.reshape(n, nq).sum(axis=1)
    return dist, bits


def _leaf_rd(org, pred, size: int, qp_scaled, bit_inc: int,
             max_val: int):
    """Luma RD estimate for one chosen mode per block."""
    import jax.numpy as jnp
    return _tq_rd(org, pred, size, jnp.asarray(qp_scaled), bit_inc, max_val)


def _gather_lines(ppad, s, nby, nbx):
    """Per-block above/left reference lines from a padded plane (1 row/col
    of edge padding on top/left, >= 2s on bottom/right): [nby*nbx, 2s+1]."""
    import jax.numpy as jnp
    ys = np.arange(nby, dtype=np.int32) * s
    xs = np.arange(nbx, dtype=np.int32) * s
    rows_above = ppad[ys, :]                           # [nby, Wp]
    ra = rows_above[:, xs[:, None] + np.arange(2 * s + 1, dtype=np.int32)]
    cols_left = jnp.swapaxes(ppad[:, xs], 0, 1)        # [nbx, Hp]
    rl = cols_left[:, ys[:, None] + np.arange(2 * s + 1, dtype=np.int32)]
    rl = jnp.swapaxes(rl, 0, 1)                        # [nby, nbx, 2s+1]
    nb = nby * nbx
    return (ra.reshape(nb, 2 * s + 1).astype(jnp.int32),
            rl.reshape(nb, 2 * s + 1).astype(jnp.int32))


def _size_pass_impl(ppad, size, nby, nbx, qp_scaled, sqrt_lam_bits3,
                    bit_inc, max_val, ctu_size, unified):
    """One luma size class over the whole frame -> (best_mode, dist, bits)
    each [nby, nbx] (bits includes the mode bits, in whole bits)."""
    import jax.numpy as jnp

    s = size
    ra, rl = _gather_lines(ppad, s, nby, nbx)
    nb = nby * nbx

    org = ppad[1:1 + nby * s, 1:1 + nbx * s]
    org = (org.reshape(nby, s, nbx, s).transpose(0, 2, 1, 3)
           .reshape(nb, s, s).astype(jnp.int32))

    # [1 2 1] smoothed reference line (initAdiPattern, TComPattern.cpp:283)
    def smooth(a, other):
        mid = (a[:, :-2] + 2 * a[:, 1:-1] + a[:, 2:] + 2) >> 2
        corner = (other[:, 1] + 2 * a[:, 0] + a[:, 1] + 2) >> 2
        return jnp.concatenate(
            [corner[:, None], mid, a[:, -1:]], axis=1)

    ra_f = smooth(ra, rl)
    rl_f = smooth(rl, ra)

    log2 = s.bit_length() - 1
    filt_pl = (min(abs(PLANAR_IDX - HOR_IDX), abs(PLANAR_IDX - VER_IDX))
               > INTRA_FILTER_THRESH[log2])
    pred_pl = _predict_mode(ra_f if filt_pl else ra,
                            rl_f if filt_pl else rl, s, PLANAR_IDX, max_val)
    pred_dc = _predict_mode(ra, rl, s, DC_IDX, max_val)
    import jax
    if unified:
        # accelerator form: ONE static gather covers all 33 angular
        # modes — one launch, seconds to compile
        pred_ang = _predict_all_angular(ra, rl, ra_f, rl_f, s, max_val)
        preds_all = jnp.concatenate(
            [pred_pl[:, None], pred_dc[:, None], pred_ang],
            axis=1).astype(jnp.int16)                  # [N, 35, s, s]
        diff = org[:, None] - preds_all.astype(jnp.int32)
        satd_all = _satd_d(diff.reshape(nb * 35, s, s),
                           s, bit_inc).reshape(nb, 35)  # [N, 35]
    else:
        # CPU form: one fused kernel per mode built from the NARROW
        # per-mode refmain (_predict_mode) — XLA:CPU vectorizes gathers
        # from these <=2s+1-wide rows, while every all-modes-at-once
        # formulation tried (one big gather from a 4L-wide canonical
        # line, lax.scan over plans, banded launches) measured 5-10x
        # slower end to end.  The cost is compile time (unrolled 35-mode
        # graph: ~3 min cold at 1080p, once per process).
        preds = [pred_pl.astype(jnp.int16), pred_dc.astype(jnp.int16)]
        satds = [_satd(org, pred_pl, s, bit_inc),
                 _satd(org, pred_dc, s, bit_inc)]
        for mode in range(2, 35):
            diffm = min(abs(mode - HOR_IDX), abs(mode - VER_IDX))
            filt = diffm > INTRA_FILTER_THRESH[log2]
            pra, prl = (ra_f, rl_f) if filt else (ra, rl)
            pred = _predict_mode(pra, prl, s, mode, max_val)
            preds.append(pred.astype(jnp.int16))
            satds.append(_satd(org, pred, s, bit_inc))
        preds_all = jnp.stack(preds, axis=1)           # [N, 35, s, s]
        satd_all = jnp.stack(satds, axis=1)            # [N, 35]

    # open-loop MPM: neighbors' SATD-best modes
    bestA = jnp.argmin(satd_all, axis=1).astype(jnp.int32).reshape(nby, nbx)
    left = jnp.concatenate(
        [jnp.full((nby, 1), DC_IDX, jnp.int32), bestA[:, :-1]], axis=1)
    above = jnp.concatenate(
        [jnp.full((1, nbx), DC_IDX, jnp.int32), bestA[:-1, :]], axis=0)
    # above PU outside the current CTU row reads as DC (TComDataCU.cpp:1931)
    ys = np.arange(nby, dtype=np.int32) * s
    if s < ctu_size:
        above_in_ctu = (ys % ctu_size) != 0
        above = jnp.where(jnp.asarray(above_in_ctu)[:, None], above, DC_IDX)
    else:
        above = jnp.full((nby, nbx), DC_IDX, jnp.int32)
    m0, m1, m2 = _mpm_vec(left.reshape(-1), above.reshape(-1))

    modes = jnp.arange(35, dtype=jnp.int32)[None, :]
    (b0, b12, bo), sqrt_lam, lam = sqrt_lam_bits3
    bits_plain = jnp.where(
        modes == m0[:, None], b0,
        jnp.where((modes == m1[:, None]) | (modes == m2[:, None]), b12, bo))
    cost = satd_all.astype(jnp.float32) + bits_plain * sqrt_lam

    # carry the top-K SATD+bits candidates into a true-RD estimate
    # (transform/quant/recon on device) and decide by RD, like the exact
    # path's candidate-list full RD (TEncSearch.cpp:2560-2590)
    k = 3
    _, topk = jax.lax.top_k(-cost, k)                  # [N, k]
    preds_k = jnp.take_along_axis(
        preds_all, topk[:, :, None, None], axis=1)     # [N, k, s, s]
    org_k = jnp.broadcast_to(org[:, None], (nb, k, s, s))
    dist_k, cbits_k = _leaf_rd(org_k.reshape(nb * k, s, s),
                               preds_k.reshape(nb * k, s, s),
                               s, qp_scaled, bit_inc, max_val)
    dist_k = dist_k.reshape(nb, k)
    cbits_k = cbits_k.reshape(nb, k)
    mbits_k = jnp.take_along_axis(bits_plain, topk, axis=1)
    rd_k = dist_k.astype(jnp.float32) + lam * (cbits_k + mbits_k)
    sel = jnp.argmin(rd_k, axis=1)
    best = jnp.take_along_axis(topk, sel[:, None], axis=1)[:, 0]
    dist = jnp.take_along_axis(dist_k, sel[:, None], axis=1)[:, 0]
    bits = jnp.take_along_axis(cbits_k + mbits_k, sel[:, None],
                               axis=1)[:, 0]
    # runner-up modes: the apply pass re-evaluates {best, second, third}
    # plus the real MPMs against real reconstructed neighbors and real
    # CABAC bits (the open-loop ranking between close candidates is the
    # main decision-quality gap)
    rd_masked = rd_k.at[jnp.arange(nb), sel].set(jnp.inf)
    sel2 = jnp.argmin(rd_masked, axis=1)
    mode2 = jnp.take_along_axis(topk, sel2[:, None], axis=1)[:, 0]
    rd_masked = rd_masked.at[jnp.arange(nb), sel2].set(jnp.inf)
    sel3 = jnp.argmin(rd_masked, axis=1)
    mode3 = jnp.take_along_axis(topk, sel3[:, None], axis=1)[:, 0]
    return (best.reshape(nby, nbx), dist.reshape(nby, nbx),
            bits.reshape(nby, nbx), mode2.reshape(nby, nbx),
            mode3.reshape(nby, nbx))


def _chroma_pass_impl(cbpad, crpad, size, nby, nbx, luma_best, dm,
                      qp_cb, qp_cr, lam_w_bits2, bit_inc, max_val):
    """The 5-candidate chroma mode RD for luma-size-class `size` CUs:
    candidates {planar, ver, hor, dc} with the luma-duplicate slot
    replaced by angular 34, plus DM (TEncSearch::estIntraPredChromaQT,
    TComDataCU::getAllowedChromaDir TComDataCU.cpp:2032).  `dm` is the
    DM-reference luma mode per block (the CU mode, or part-0's mode for
    an NxN 8x8).  Returns (stored chroma dir [nby,nbx] int32 — the mode
    value, or 36 for DM — and the RD cost [nby,nbx] float32 of the
    winner: weighted dist + lambda * (coeff bits + mode bits))."""
    import jax.numpy as jnp

    (bits_dm, bits_oth), lam, cw = lam_w_bits2
    c = size // 2                      # chroma block size (>= 4)
    nb = nby * nbx
    ra_b, rl_b = _gather_lines(cbpad, c, nby, nbx)
    ra_r, rl_r = _gather_lines(crpad, c, nby, nbx)
    dm = dm.reshape(-1).astype(jnp.int32)
    luma_best = luma_best.reshape(-1).astype(jnp.int32)

    def org_of(ppad):
        o = ppad[1:1 + nby * c, 1:1 + nbx * c]
        return (o.reshape(nby, c, nbx, c).transpose(0, 2, 1, 3)
                .reshape(nb, c, c).astype(jnp.int32))

    org_cb, org_cr = org_of(cbpad), org_of(crpad)

    def preds_of(ra, rl):
        # full 35-mode stack (chroma: unfiltered refs, no DC/edge filters)
        p_pl = _predict_mode(ra, rl, c, PLANAR_IDX, max_val, luma=False)
        p_dc = _predict_mode(ra, rl, c, DC_IDX, max_val, luma=False)
        p_ang = _predict_all_angular(ra, rl, ra, rl, c, max_val,
                                     luma=False)
        return jnp.concatenate([p_pl[:, None], p_dc[:, None], p_ang],
                               axis=1)                 # [N, 35, c, c]

    pred_cb = preds_of(ra_b, rl_b)
    pred_cr = preds_of(ra_r, rl_r)

    fixed = (PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX)

    def cands_of(pred_all):
        p34 = pred_all[:, 34]
        outs = []
        for fm in fixed:
            sub = (luma_best == fm)[:, None, None]
            outs.append(jnp.where(sub, p34, pred_all[:, fm]))
        p_dm = jnp.take_along_axis(
            pred_all, dm[:, None, None, None], axis=1)[:, 0]
        outs.append(p_dm)
        return jnp.stack(outs, axis=1)                 # [N, 5, c, c]

    cb5 = cands_of(pred_cb).reshape(nb * 5, c, c)
    cr5 = cands_of(pred_cr).reshape(nb * 5, c, c)
    ocb = jnp.broadcast_to(org_cb[:, None], (nb, 5, c, c)).reshape(
        nb * 5, c, c)
    ocr = jnp.broadcast_to(org_cr[:, None], (nb, 5, c, c)).reshape(
        nb * 5, c, c)
    # a 64-CU's chroma transforms at 16 (the luma TU split to 32 is
    # mandatory, so the chroma tree follows): quadrant transforms
    tq_size = -32 if c == 32 else c
    qpb = jnp.full((nb * 5,), qp_cb, jnp.int32)
    qpr = jnp.full((nb * 5,), qp_cr, jnp.int32)
    d_cb, b_cb = _tq_rd(ocb, cb5, tq_size, qpb, bit_inc, max_val)
    d_cr, b_cr = _tq_rd(ocr, cr5, tq_size, qpr, bit_inc, max_val)
    dist = (d_cb + d_cr).reshape(nb, 5).astype(jnp.float32)
    cbits = (b_cb + b_cr).reshape(nb, 5)
    mbits = jnp.stack([jnp.asarray(b, jnp.float32) for b in
                       (bits_oth, bits_oth, bits_oth, bits_oth,
                        bits_dm)])[None, :]
    cost = cw * dist + lam * (cbits + mbits)
    sel = jnp.argmin(cost, axis=1)                     # [N]
    best_cost = jnp.take_along_axis(cost, sel[:, None], axis=1)[:, 0]
    # the stored direction value per candidate slot
    vals = []
    for fm in fixed:
        vals.append(jnp.where(luma_best == fm, 34, fm))
    vals.append(jnp.full((nb,), DM_CHROMA_IDX, jnp.int32))
    vals = jnp.stack(vals, axis=1)                     # [N, 5]
    best_val = jnp.take_along_axis(vals, sel[:, None], axis=1)[:, 0]
    return (best_val.reshape(nby, nbx), best_cost.reshape(nby, nbx))


# per-CU header-bit constants for the DP (split flag, part size, cbf
# scaffolding) — coarse, tuned on synthetic content
_CU_BITS = 5.0
_SPLIT_BITS = 1.0
_NXN_BITS = 3.0


def _dp_expand(res, cres, cres8_nxn, width, height, lam, max_sig,
               min_tr_log2, ctu_size, wp, hp, inter=None,
               intra_pen: float = 0.0):
    """Bottom-up quadtree DP + per-4x4-unit map expansion, in jnp (runs
    inside the device launch; the packed maps are the only fetch).

    res[s] = (mode, dist, bits, mode2, mode3) luma per block; cres[s] =
    (cdir, ccost) for s >= 8; cres8_nxn = the NxN-variant chroma decision
    at s=8.  inter (P slices): {s: (rd, mvx, mvy, ref)} — the leaf then
    takes min(intra, inter) and the maps gain pred/ref/MV planes.  B
    slices pass 8-tuples {s: (rd, mvx0, mvy0, ref0, dir, mvx1, mvy1,
    ref1)} and the maps additionally gain dir + L1 ref/MV planes.
    Returns stacked int8 maps [6, 12 or 18, hp//4, wp//4].
    """
    import jax.numpy as jnp

    BIG = jnp.float32(1e30)
    lamf = jnp.asarray(lam, jnp.float32)
    cost = {}
    choice = {}
    pred_inter = {}
    min_cu = ctu_size >> max_sig
    for s in SIZES:
        if s > ctu_size:
            continue
        mode, dist, bits = res[s][0], res[s][1], res[s][2]
        leaf = (dist.astype(jnp.float32)
                + lamf * (bits + jnp.float32(_CU_BITS)))
        if s >= 8:
            leaf = leaf + cres[s][1]
        if inter is not None and s >= 8:
            # intra CU in an inter slice: pred_mode/part-size signaling
            # plus the open-loop optimism of org-neighbor prediction
            # (the real encode predicts from recon) — without this the
            # DP picks intra for units the exact path codes as skip
            leaf = leaf + lamf * jnp.float32(intra_pen)
        if inter is not None and s in inter:
            ileaf = inter[s][0] + lamf * jnp.float32(3.0)
            pred_inter[s] = ileaf < leaf
            leaf = jnp.minimum(leaf, ileaf)
        nby, nbx = leaf.shape
        ys = (np.arange(nby) * s)[:, None]
        xs = (np.arange(nbx) * s)[None, :]
        crosses = ((ys < height) & (ys + s > height)) | \
                  ((xs < width) & (xs + s > width))
        outside = (ys >= height) | (xs >= width)
        leaf = jnp.where(jnp.asarray(crosses), BIG, leaf)
        leaf = jnp.where(jnp.asarray(outside), jnp.float32(0.0), leaf)
        if s == 4:
            cost[4] = leaf
            continue
        if s == 8:
            child = cost[4]
            csum = (child[0::2, 0::2] + child[0::2, 1::2]
                    + child[1::2, 0::2] + child[1::2, 1::2])
            # NxN partition (not a CU split): add its chroma cost
            split = csum + cres8_nxn[1] + lamf * jnp.float32(_NXN_BITS)
            if inter is not None:
                split = split + lamf * jnp.float32(intra_pen)
            can = 8 > (1 << min_tr_log2) and 4 >= min_cu
        else:
            child = cost[s // 2]
            csum = (child[0::2, 0::2] + child[0::2, 1::2]
                    + child[1::2, 0::2] + child[1::2, 1::2])
            split = csum + lamf * jnp.float32(_SPLIT_BITS)
            can = s > min_cu
        if can:
            take = split < leaf
            cost[s] = jnp.where(take, split, leaf)
            choice[s] = take
        else:
            cost[s] = leaf
            choice[s] = jnp.zeros_like(leaf, bool)

    uw, uh = wp // 4, hp // 4

    def up(a, un):
        return jnp.repeat(jnp.repeat(a, un, axis=0), un, axis=1)

    fd_depth = jnp.zeros((uh, uw), jnp.int8)
    fd_mode = jnp.full((uh, uw), DC_IDX, jnp.int8)
    fd_nxn = jnp.zeros((uh, uw), jnp.int8)
    fd_chroma = jnp.full((uh, uw), DM_CHROMA_IDX, jnp.int8)
    fd_mode2 = jnp.full((uh, uw), DC_IDX, jnp.int8)
    fd_mode3 = jnp.full((uh, uw), DC_IDX, jnp.int8)
    is_b = inter is not None and \
        len(next(iter(inter.values()))) == 8
    if inter is not None:
        fd_pred = jnp.zeros((uh, uw), jnp.int8)
        fd_ref = jnp.zeros((uh, uw), jnp.int8)
        fd_mvx = jnp.zeros((uh, uw), jnp.int32)
        fd_mvy = jnp.zeros((uh, uw), jnp.int32)
    if is_b:
        fd_dir = jnp.ones((uh, uw), jnp.int8)
        fd_ref1 = jnp.zeros((uh, uw), jnp.int8)
        fd_mvx1 = jnp.zeros((uh, uw), jnp.int32)
        fd_mvy1 = jnp.zeros((uh, uw), jnp.int32)

    top = min(ctu_size, max(SIZES))
    open_ = jnp.ones((hp // top, wp // top), bool)
    s = top
    depth = 0
    mode4 = res[4][0].astype(jnp.int8)
    mode4b = res[4][3].astype(jnp.int8)
    mode4c = res[4][4].astype(jnp.int8)
    while s >= 8:
        can_descend = (s > min_cu) or (s == 8 and 8 > (1 << min_tr_log2))
        split_here = (open_ & choice[s]) if can_descend \
            else jnp.zeros_like(open_)
        leaf_here = open_ & ~split_here
        un = s // 4
        lm = up(leaf_here, un)
        fd_depth = jnp.where(lm, jnp.int8(depth), fd_depth)
        fd_mode = jnp.where(lm, up(res[s][0].astype(jnp.int8), un), fd_mode)
        fd_mode2 = jnp.where(lm, up(res[s][3].astype(jnp.int8), un),
                             fd_mode2)
        fd_mode3 = jnp.where(lm, up(res[s][4].astype(jnp.int8), un),
                             fd_mode3)
        fd_chroma = jnp.where(lm, up(cres[s][0].astype(jnp.int8), un),
                              fd_chroma)
        if inter is not None and s in inter:
            im = lm & up(pred_inter[s], un)
            fd_pred = jnp.where(im, jnp.int8(1), fd_pred)
            fd_ref = jnp.where(im, up(inter[s][3].astype(jnp.int8), un),
                               fd_ref)
            fd_mvx = jnp.where(im, up(inter[s][1], un), fd_mvx)
            fd_mvy = jnp.where(im, up(inter[s][2], un), fd_mvy)
            if is_b:
                fd_dir = jnp.where(
                    im, up(inter[s][4].astype(jnp.int8), un), fd_dir)
                fd_ref1 = jnp.where(
                    im, up(inter[s][7].astype(jnp.int8), un), fd_ref1)
                fd_mvx1 = jnp.where(im, up(inter[s][5], un), fd_mvx1)
                fd_mvy1 = jnp.where(im, up(inter[s][6], un), fd_mvy1)
        if s == 8:
            # split at 8 means an NxN-PU 8x8 CU, not a CU split: per-4x4
            # modes come from the 4x4 pass (already at unit granularity)
            nm = up(split_here, 2)
            fd_depth = jnp.where(nm, jnp.int8(depth), fd_depth)
            fd_nxn = jnp.where(nm, jnp.int8(1), fd_nxn)
            fd_mode = jnp.where(nm, mode4, fd_mode)
            fd_mode2 = jnp.where(nm, mode4b, fd_mode2)
            fd_mode3 = jnp.where(nm, mode4c, fd_mode3)
            fd_chroma = jnp.where(nm, up(cres8_nxn[0].astype(jnp.int8), 2),
                                  fd_chroma)
            break
        open_ = up(split_here, 2)
        s //= 2
        depth += 1

    def mv_planes(mx, my):
        mx16, my16 = mx.astype(jnp.int16), my.astype(jnp.int16)
        return [(mx16 & 0xFF).astype(jnp.int8),
                (mx16 >> 8).astype(jnp.int8),
                (my16 & 0xFF).astype(jnp.int8),
                (my16 >> 8).astype(jnp.int8)]

    planes = [fd_depth, fd_mode, fd_nxn, fd_chroma, fd_mode2, fd_mode3]
    if inter is not None:
        planes += [fd_pred, fd_ref] + mv_planes(fd_mvx, fd_mvy)
    if is_b:
        planes += [fd_dir, fd_ref1] + mv_planes(fd_mvx1, fd_mvy1)
    return jnp.stack(planes)


def _decision_device():
    """Device for the decision pass: honors THEVC_DEVICE — when offload is
    off the pass stays on the host CPU; when on, it runs on the device in
    force (a `with jax.default_device(d)` block places a stream's pass on
    card d)."""
    import jax
    from ..ops.device import current_device, device_enabled
    if device_enabled():
        return current_device()
    return jax.devices("cpu")[0]


_frame_pass_cache = {}
_frame_pass_lock = None


def _frame_body(py, pcb, pcr, iscal, fscal, wp, hp, statics, max_sig,
                min_tr_log2, unified):
    """The whole decision problem for one frame: luma size classes,
    chroma candidates, quadtree DP, unit-map expansion -> packed int8
    [5, hp//4, wp//4] (depth, mode, nxn, chroma, mode2).

    iscal/fscal carry the per-frame scalars (QPs, lambda, mode-bit
    estimates) as TRACED values so a QP or lambda change never
    recompiles — only the frame geometry is baked into the graph."""
    import jax.numpy as jnp

    (width, height, bit_inc, max_val, ctu_size) = statics
    qp_scaled, qp_cb, qp_cr = iscal[0], iscal[1], iscal[2]
    lam, sqrt_lam = fscal[0], fscal[1]
    bits3 = (fscal[2], fscal[3], fscal[4])
    c_dm, c_oth, cw = fscal[5], fscal[6], fscal[7]
    sqrt_lam_bits3 = (bits3, sqrt_lam, lam)
    py = py.astype(jnp.int32)
    pcb = pcb.astype(jnp.int32)
    pcr = pcr.astype(jnp.int32)
    res = {}
    for s in SIZES:
        if s > ctu_size:
            continue
        res[s] = _size_pass_impl(py, s, hp // s, wp // s, qp_scaled,
                                 sqrt_lam_bits3, bit_inc, max_val,
                                 ctu_size, unified)
    cres = {}
    lam_w_bits2 = ((c_dm, c_oth), lam, cw)
    for s in SIZES:
        if s > ctu_size or s < 8:
            continue
        cres[s] = _chroma_pass_impl(
            pcb, pcr, s, hp // s, wp // s, res[s][0], res[s][0],
            qp_cb, qp_cr, lam_w_bits2, bit_inc, max_val)
    # NxN 8x8 variant: DM is part 0's (top-left 4x4's) mode
    dm_nxn = res[4][0][0::2, 0::2]
    cres8_nxn = _chroma_pass_impl(
        pcb, pcr, 8, hp // 8, wp // 8, dm_nxn, dm_nxn,
        qp_cb, qp_cr, lam_w_bits2, bit_inc, max_val)
    return _dp_expand(res, cres, cres8_nxn, width, height, lam,
                      max_sig, min_tr_log2, ctu_size, wp, hp)


def _frame_pass(py, pcb, pcr, iscal, fscal, wp, hp, statics, max_sig,
                min_tr_log2):
    """All decision work for the whole frame in ONE jitted launch.

    One dispatch per frame: the decision graph has hundreds of ops, so
    fine-grained launches (e.g. one per CTU-row band) pay per-launch
    overhead many times over; full-frame batches amortize it.

    The launch returns ONE packed int8 [4, uh, uw] array: one
    device->host fetch of the final decision maps only (~0.5 MB at
    1080p), not per-size intermediates."""
    import jax
    import os

    unified = (_decision_device().platform != "cpu"
               or os.environ.get("THEVC_FASTRD_UNIFIED") == "1")
    key = (py.shape, py.dtype.name, wp, hp, statics, max_sig, min_tr_log2,
           unified)
    global _frame_pass_lock
    if _frame_pass_lock is None:
        import threading
        _frame_pass_lock = threading.Lock()
    with _frame_pass_lock:
        fn = _frame_pass_cache.get(key)
        if fn is None:
            fn = jax.jit(partial(_frame_body, wp=wp, hp=hp,
                                 statics=statics,
                                 max_sig=max_sig, min_tr_log2=min_tr_log2,
                                 unified=unified))
            _frame_pass_cache[key] = fn
    return fn(py, pcb, pcr, iscal, fscal)   # device array, not yet fetched


def chroma_bits2(init_ctx, chroma_weight: float) -> tuple:
    """The two intra_chroma_pred_mode bit classes at slice-init context,
    in whole bits: DM (one '0' ctx bin) vs the rest ('1' ctx bin + 2 EP
    bins) (TEncSbac::codeIntraDirChroma)."""
    from ..cabac import contexts as cc
    from ..cabac.tables import ENTROPY_BITS

    st = int(init_ctx[cc.O_CHROMA_PRED])
    b1 = int(ENTROPY_BITS[st ^ 1])
    b0 = int(ENTROPY_BITS[st ^ 0])
    ep = 32768
    return (b0 / 32768.0, (b1 + 2 * ep) / 32768.0, float(chroma_weight))


def dispatch_frame(org_y: np.ndarray, org_cb: np.ndarray,
                   org_cr: np.ndarray, width: int, height: int,
                   qp_scaled: int, qp_cb: int, qp_cr: int, lambda_: float,
                   sqrt_lambda: float, bits3: tuple, cbits2: tuple,
                   max_sig: int, min_tr_log2: int,
                   ctu_size: int = 64, bit_inc: int = 0,
                   max_val: int = 255):
    """Start the decision pass for one frame: upload + device dispatch only.

    Returns an opaque token for collect_frame.  The device computes
    asynchronously after this returns, so a caller can overlap the pass
    for frame N+1 with the host apply loop for frame N (all-intra
    decisions are open-loop: they depend only on the source picture).
    """
    import jax

    pad = ctu_size * 2
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size
    ppad = np.pad(org_y, ((1, hp - height + pad), (1, wp - width + pad)),
                  mode="edge")
    cpad = ctu_size
    wc, hc = width // 2, height // 2
    cbp = np.pad(org_cb, ((1, hp // 2 - hc + cpad), (1, wp // 2 - wc + cpad)),
                 mode="edge")
    crp = np.pad(org_cr, ((1, hp // 2 - hc + cpad), (1, wp // 2 - wc + cpad)),
                 mode="edge")

    statics = (width, height, bit_inc, max_val, ctu_size)
    iscal_np = np.asarray([qp_scaled, qp_cb, qp_cr], np.int32)
    fscal_np = np.asarray(
        [lambda_, sqrt_lambda, bits3[0], bits3[1], bits3[2],
         cbits2[0], cbits2[1], cbits2[2]], np.float32)

    dev = _decision_device()
    if dev.platform == "cpu":
        import jax.numpy as jnp
        py = jnp.asarray(ppad, jnp.int32)   # uncommitted: jit fastpath
        pcb = jnp.asarray(cbp, jnp.int32)
        pcr = jnp.asarray(crp, jnp.int32)
        iscal, fscal = jnp.asarray(iscal_np), jnp.asarray(fscal_np)
    else:
        # jit placement follows the committed input device (a
        # jax.default_device CONTEXT would route every call through the
        # slow dispatch path: measured 125 ms/call vs <1 ms); ship the
        # narrowest dtype — host->device transfer is cheap but not free
        ship = np.uint8 if max_val <= 255 else np.int16
        py = jax.device_put(ppad.astype(ship), dev)
        pcb = jax.device_put(cbp.astype(ship), dev)
        pcr = jax.device_put(crp.astype(ship), dev)
        iscal = jax.device_put(iscal_np, dev)
        fscal = jax.device_put(fscal_np, dev)
    out = _frame_pass(py, pcb, pcr, iscal, fscal, wp, hp, statics,
                      max_sig, min_tr_log2)
    from ..ops.device import stat_launch
    stat_launch(ppad.nbytes + cbp.nbytes + crp.nbytes, device=dev)
    return (out, wp, hp)


def collect_frame(token):
    """Finish a dispatched decision pass: one packed fetch -> unit maps."""
    out, wp, hp = token
    packed = np.asarray(out)
    fd_depth, fd_mode, fd_nxn, fd_chroma, fd_mode2, fd_mode3 = packed
    return (fd_depth, fd_mode, np.ascontiguousarray(fd_nxn, np.uint8),
            fd_chroma, fd_mode2, fd_mode3)


def decide_frame(org_y, org_cb, org_cr, width: int, height: int,
                 qp_scaled: int, qp_cb: int, qp_cr: int,
                 lambda_: float, sqrt_lambda: float, bits3: tuple,
                 cbits2: tuple, max_sig: int, min_tr_log2: int,
                 ctu_size: int = 64, bit_inc: int = 0, max_val: int = 255):
    """Run the decision pass for one frame synchronously.

    org_*: source planes int16; bits3: (mpm0, mpm12, other) intra-dir
    bit estimates in whole bits; cbits2: (dm, other, chroma_weight).
    Returns (fd_depth, fd_mode, fd_nxn, fd_chroma) per 4x4 unit, ready
    for enc_set_fd.
    """
    return collect_frame(dispatch_frame(
        org_y, org_cb, org_cr, width, height, qp_scaled, qp_cb, qp_cr,
        lambda_, sqrt_lambda, bits3, cbits2, max_sig, min_tr_log2,
        ctu_size, bit_inc, max_val))


def mode_bits3(sh, pps, init_ctx) -> tuple:
    """The three xModeBitsIntra bit classes (mpm idx 0 / mpm idx 1-2 /
    non-mpm) at slice-init context, in whole bits."""
    from ..cabac import contexts as cc
    from ..cabac.tables import ENTROPY_BITS

    st = int(init_ctx[cc.O_INTRA_PRED])
    b_flag1 = int(ENTROPY_BITS[st ^ 1])
    b_flag0 = int(ENTROPY_BITS[st ^ 0])
    ep = 32768
    return ((b_flag1 + ep) / 32768.0,
            (b_flag1 + 2 * ep) / 32768.0,
            (b_flag0 + 5 * ep) / 32768.0)
