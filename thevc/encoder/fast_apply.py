"""Device-resident fast-RD intra apply: the closed-loop wavefront.

The decision pass (encoder/fast_intra.py) fixes the quadtree, per-CU luma
modes and chroma modes open-loop.  This module then runs the entire APPLY
math on the accelerator — prediction from real reconstructed neighbors,
forward transform, quantization (+ sign-bit hiding), dequant, inverse
transform, reconstruction — leaving the host nothing but entropy coding
(VERDICT r04 item #1: host = CABAC only).

How the sequential intra dependency becomes a device program:

  1. The native schedule builder (codec_core.cpp enc_fd_schedule) walks
     the fixed tree in decode order and computes, per TU, (a) the
     reference-line availability clamp [lo, hi] — HM's unavailable-sample
     substitution (TComPattern.cpp:368,495-534) over a CONTIGUOUS
     available range is exactly `source = clamp(scan_index, lo, hi)` —
     and (b) the earliest wave at which the TU may execute: one more than
     the latest wave among the units its clamped reference line reads.
     This is the exact longest-path levelization of the recon dependency
     DAG, so TUs in the same wave are provably independent.
  2. Per size class (luma 4/8/16/32 with DST on 4, chroma 4/8/16) the TU
     records are sorted by wave; the device runs ONE `lax.while_loop`
     over waves.  Each step takes a fixed-capacity window of each class's
     records (entries beyond the wave recompute harmlessly later — a
     region is never read before its owner's wave has run), gathers
     reference lines straight out of the evolving recon planes, predicts
     (planar / DC+filter / all-33-angular via the static gather plans of
     fast_intra._unified_plan, edge filters included — integer-exact
     mirror of TComPrediction.cpp:190,689,1010), transforms, then
     quantizes with the in-launch RDOQ (_rdoq_batch) or plain quant
     (TComTrQuant.cpp:1102), applies sign-bit hiding (signBitHidingHDQ,
     TComTrQuant.cpp:977 — bit-exact vectorized mirror), reconstructs,
     scatters recon into the planes and levels into flat per-record
     stacks.  Source windows are pre-extracted and every table read is
     a static shuffle or masked select rather than a per-element dynamic
     gather (a formulation kept from the first target); classes with no
     records in a wave are skipped via lax.cond.
  3. One fetch returns the recon planes (uint8 for 8-bit content) and
     the per-record level stacks; the host assembles the coefficient
     planes (one vectorized numpy scatter), fills the syntax arrays
     (enc_fill_from_fd), runs the counter pass for CABAC contexts, SAO
     RDO and the real entropy pass.

With RDOQ off this path is BYTE-IDENTICAL to the host fast-RD apply
(tests/test_fast_apply.py); with RDOQ on it swaps the host RDOQ for the
in-launch frozen-context RDOQ (rate cost measured in bench extra).
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

from ..common import rom
from .fast_intra import _unified_plan
from ..ops.intra import (DC_IDX, HOR_IDX, INTRA_FILTER_THRESH, PLANAR_IDX,
                         VER_IDX)

# class table: (size, is_luma, use_dst)
CLS = ((4, True, True), (8, True, False), (16, True, False),
       (32, True, False), (4, False, False), (8, False, False),
       (16, False, False))
GUARD = 48          # bottom/right guard so edge gathers stay in-bounds


# ---------------------------------------------------------------------------
# schedule build (host, native)
# ---------------------------------------------------------------------------

class Schedule:
    __slots__ = ("n_waves", "flat", "offs", "caps", "counts")


def build_schedule(fd_depth, fd_mode, fd_nxn, fd_chroma, width, height,
                   ctu_size, max_sig, min_tr_log2):
    """Run the native wavefront schedule builder and bucket the TU records
    per size class sorted by wave.  Returns a Schedule or None when the
    frame needs the host fallback (non-contiguous availability)."""
    import ctypes
    from .. import native
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "enc_fd_schedule"):
        return None
    uh, uw = fd_depth.shape
    ctus_w = (uw * 4) // ctu_size
    ctus_h = (uh * 4) // ctu_size
    cap = uh * uw + (uh * uw) // 2 + 64
    xs = np.empty(cap, np.int32)
    ys = np.empty(cap, np.int32)
    lo = np.empty(cap, np.int32)
    hi = np.empty(cap, np.int32)
    wave = np.empty(cap, np.int32)
    cls = np.empty(cap, np.int8)
    mode = np.empty(cap, np.int8)
    scan = np.empty(cap, np.int8)
    nw = ctypes.c_int32(0)
    fd_depth = np.ascontiguousarray(fd_depth, np.int8)
    fd_mode = np.ascontiguousarray(fd_mode, np.int8)
    fd_nxn = np.ascontiguousarray(fd_nxn, np.uint8)
    fd_chroma = np.ascontiguousarray(fd_chroma, np.int8)
    n = lib.enc_fd_schedule(
        uw, uh, width, height, ctu_size, ctus_w, ctus_h, max_sig,
        min_tr_log2, fd_depth.ctypes.data, fd_nxn.ctypes.data,
        fd_mode.ctypes.data, fd_chroma.ctypes.data, xs.ctypes.data,
        ys.ctypes.data, lo.ctypes.data, hi.ctypes.data, wave.ctypes.data,
        cls.ctypes.data, mode.ctypes.data, scan.ctypes.data, cap,
        ctypes.byref(nw))
    if n < 0:
        return None
    s = Schedule()
    s.n_waves = int(nw.value)
    s.flat, s.offs, s.caps, s.counts = [], [], [], []
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size
    for ci in range(len(CLS)):
        luma = CLS[ci][1]
        sel = np.nonzero(cls[:n] == ci)[0]
        order = sel[np.argsort(wave[sel], kind="stable")]
        w_sorted = wave[order]
        offs = np.searchsorted(w_sorted, np.arange(s.n_waves + 1)
                               ).astype(np.int32)
        occ = np.diff(offs)
        cap_c = int(occ.max()) if occ.size and occ.max() > 0 else 1
        cap_c = max(8, 1 << int(np.ceil(np.log2(cap_c))))
        # pad the flat arrays by the window size so dynamic_slice at the
        # last offset stays in-bounds; padding records point into the
        # guard region (scatters land there and are cropped away — a
        # padding record must NEVER alias a real position: an empty
        # class's all-zero record at (0,0) would otherwise overwrite the
        # real top-left TU on every wave)
        dummy_x = (wp if luma else wp // 2) + 2
        dummy_y = (hp if luma else hp // 2) + 2
        pads = {id(xs): dummy_x, id(ys): dummy_y, id(lo): 1, id(hi): 0,
                id(mode): DC_IDX, id(scan): 3}

        def padded(a):
            fill = pads[id(a)]
            v = a[order].astype(np.int32) if order.size else \
                np.zeros((0,), np.int32)
            return np.concatenate(
                [v, np.full(cap_c, fill, np.int32)])
        s.flat.append((padded(xs), padded(ys), padded(lo),
                       padded(hi), padded(mode), padded(scan)))
        s.offs.append(offs)
        s.caps.append(cap_c)
        s.counts.append(int(order.size))
    return s


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def _scan_tables(size: int) -> np.ndarray:
    """[3, size*size] raster positions for scan_idx 1 (hor-ish), 2
    (ver-ish), 3 (diag) in CG-major coefficient order."""
    return np.stack([np.asarray(rom.sig_last_scan(i, size), np.int32)
                     .reshape(-1) for i in (1, 2, 3)])


def _predict_batch(ra, rl, size: int, luma: bool, mode, max_val: int):
    """Single-mode intra prediction for a TU batch: ra/rl [N, 2s+1],
    mode [N] -> [N, s, s].  Integer-exact mirror of ops.intra.predict
    (planar :689 / DC + xDCPredFiltering :1010 / xPredIntraAng :190 with
    the [1 2 1] smoothing choice baked into the gather plans)."""
    import jax.numpy as jnp

    s = size
    nb = ra.shape[0]
    log2 = s.bit_length() - 1

    def smooth(a, other):
        mid = (a[:, :-2] + 2 * a[:, 1:-1] + a[:, 2:] + 2) >> 2
        corner = (other[:, 1] + 2 * a[:, 0] + a[:, 1] + 2) >> 2
        return jnp.concatenate([corner[:, None], mid, a[:, -1:]], axis=1)

    if luma:
        ra_f, rl_f = smooth(ra, rl), smooth(rl, ra)
        c = jnp.concatenate([rl, ra[:, 1:], rl_f, ra_f[:, 1:]], axis=1)
    else:
        ra_f, rl_f = ra, rl
        c = jnp.concatenate([rl, ra[:, 1:]], axis=1)

    # angular 2..34 via the static per-mode gather plans
    idx_a, idx_b, frac = _unified_plan(s, luma)
    m = jnp.clip(mode - 2, 0, 32)
    ia = jnp.asarray(idx_a)[m].reshape(nb, -1)
    ib = jnp.asarray(idx_b)[m].reshape(nb, -1)
    fr = jnp.asarray(frac)[m].reshape(nb, -1)
    a = jnp.take_along_axis(c, ia, axis=1)
    b = jnp.take_along_axis(c, ib, axis=1)
    ang = (((32 - fr) * a + fr * b + 16) >> 5).reshape(nb, s, s)
    if luma:
        # pure-copy edge filters (xPredIntraAng :268)
        d26 = (rl[:, 1:s + 1] - rl[:, 0:1]) >> 1
        col = jnp.clip(ang[:, :, 0] + d26, 0, max_val)
        ang = jnp.where((mode == 26)[:, None, None],
                        ang.at[:, :, 0].set(col), ang)
        d10 = (ra[:, 1:s + 1] - ra[:, 0:1]) >> 1
        row = jnp.clip(ang[:, 0, :] + d10, 0, max_val)
        ang = jnp.where((mode == 10)[:, None, None],
                        ang.at[:, 0, :].set(row), ang)

    # planar (filtered refs when the size-filter applies, luma only)
    filt_pl = luma and (min(abs(PLANAR_IDX - HOR_IDX),
                            abs(PLANAR_IDX - VER_IDX))
                        > INTRA_FILTER_THRESH[log2])
    pra, prl = (ra_f, rl_f) if filt_pl else (ra, rl)
    top = pra[:, 1:s + 2]
    left = prl[:, 1:s + 2]
    bl = left[:, s][:, None]
    tr = top[:, s][:, None]
    bottom = bl - top[:, :s]
    right = tr - left[:, :s]
    kk = jnp.arange(1, s + 1, dtype=jnp.int32)
    hor = ((left[:, :s, None] << log2) + s
           + kk[None, None, :] * right[:, :s, None])
    ver = ((top[:, None, :s] << log2) + kk[None, :, None]
           * bottom[:, None, :s])
    pl = (hor + ver) >> (log2 + 1)

    # DC (+ luma filtering)
    ssum = ra[:, 1:s + 1].sum(axis=1) + rl[:, 1:s + 1].sum(axis=1)
    dcv = (ssum + s) // (2 * s)
    dc = jnp.broadcast_to(dcv[:, None, None], (nb, s, s))
    if luma:
        # xDCPredFiltering — every filtered sample reads the ORIGINAL
        # flat DC value, so compute all three edits from dcv
        t0 = ra[:, 1:s + 1]
        l0 = rl[:, 1:s + 1]
        dc = dc.at[:, 0, :].set((t0 + 3 * dcv[:, None] + 2) >> 2)
        dc = dc.at[:, :, 0].set((l0 + 3 * dcv[:, None] + 2) >> 2)
        dc = dc.at[:, 0, 0].set(
            (t0[:, 0] + l0[:, 0] + 2 * dcv + 2) >> 2)

    return jnp.where((mode == PLANAR_IDX)[:, None, None], pl,
                     jnp.where((mode == DC_IDX)[:, None, None], dc, ang))


_rdoq_tab_cache = {}


def _rdoq_tables(size: int, luma: bool):
    """Static RDOQ constants for one class: per-scan significance-context
    maps (TComTrQuant getSigCtxInc via encoder.rdoq._sig_ctx), CG
    neighbor indices for the pattern/context proxies, and last-position
    group tables."""
    key = (size, luma)
    t = _rdoq_tab_cache.get(key)
    if t is not None:
        return t
    from .rdoq import _sig_ctx
    p = size * size
    ncg = max(1, p // 16)
    log2 = size.bit_length() - 1
    comp = 0 if luma else 1
    sig = np.zeros((3, 4, p), np.int32)
    for si, scan_idx in enumerate((1, 2, 3)):
        scan = np.asarray(rom.sig_last_scan(scan_idx, size)).reshape(-1)
        for pat in range(4):
            pt = -1 if size == 4 else pat
            for sp in range(p):
                blk = int(scan[sp])
                py, px = blk >> log2, blk & (size - 1)
                sig[si, pat, sp] = _sig_ctx(pt, scan_idx, px, py, log2,
                                            comp)
    # CG neighbors in CG-scan-index space (right / lower in raster)
    rgt = np.full((3, ncg), ncg, np.int32)      # ncg = "none" slot
    low = np.full((3, ncg), ncg, np.int32)
    n = size >> 2
    glx = np.zeros((3, p), np.int32)            # GROUP_IDX of last-x
    gly = np.zeros((3, p), np.int32)
    gep = np.zeros((3, p), np.int32)            # EP suffix bits
    for si, scan_idx in enumerate((1, 2, 3)):
        if n:
            cg = np.asarray(rom.cg_scan(scan_idx, size)).reshape(-1)
            inv = np.empty(n * n, np.int32)
            inv[cg] = np.arange(n * n)
            for g in range(n * n):
                blk = int(cg[g])
                cy, cx = blk // n, blk % n
                if cx < n - 1:
                    rgt[si, g] = inv[cy * n + cx + 1]
                if cy < n - 1:
                    low[si, g] = inv[(cy + 1) * n + cx]
        scan = np.asarray(rom.sig_last_scan(scan_idx, size)).reshape(-1)
        for sp in range(p):
            blk = int(scan[sp])
            py, px = blk >> log2, blk & (size - 1)
            if scan_idx == rom.SCAN_VER:
                px, py = py, px
            cx = int(rom.GROUP_IDX[px])
            cy = int(rom.GROUP_IDX[py])
            glx[si, sp] = cx
            gly[si, sp] = cy
            ep = 0
            if cx > 3:
                ep += (cx - 2) >> 1
            if cy > 3:
                ep += (cy - 2) >> 1
            gep[si, sp] = ep << 15
    t = (sig, rgt, low, glx, gly, gep)
    _rdoq_tab_cache[key] = t
    return t


_est_bits_cache = {}


def est_bits_pack(init_ctx: np.ndarray, size: int, luma: bool):
    """EstBits tables for one class at the slice-init context states,
    packed as int32 arrays for the device (frozen-context approximation
    of HM's per-CU estBit snapshots)."""
    key = (init_ctx.tobytes(), size, luma)
    t = _est_bits_cache.get(key)
    if t is not None:
        return t
    from .sbac_writer import build_est_bits
    eb = build_est_bits(init_ctx, size, luma)
    sig = np.asarray(eb.sig_bits, np.int32)
    lastx = np.asarray(eb.last_x_bits, np.int64)
    lasty = np.asarray(eb.last_y_bits, np.int64)
    sigmap, _rgt, _low, glx, gly, gep = _rdoq_tables(size, luma)
    # per-(scan, pattern, position) sig-flag bits and per-(scan,
    # position) last-position rates, combined host-side so the device
    # reads them with masked selects instead of serialized gathers
    sig0p = sig[sigmap, 0].astype(np.float32)         # [3, 4, P]
    sig1p = sig[sigmap, 1].astype(np.float32)
    rlv = (lastx[glx] + lasty[gly] + gep).astype(np.float32)   # [3, P]
    t = dict(
        sig=sig,
        one=np.asarray(eb.greater_one_bits, np.int32),
        abs_=np.asarray(eb.level_abs_bits, np.int32),
        cg=np.asarray(eb.sig_cg_bits, np.int32),
        cbp=np.asarray(eb.block_cbp_bits, np.int32),
        sig0p=sig0p, sig1p=sig1p, rlv=rlv,
    )
    _est_bits_cache[key] = t
    return t


def _bitlen(x):
    """floor(log2(x)) + 1 for x >= 1, elementwise (int32)."""
    import jax.numpy as jnp
    out = jnp.zeros_like(x)
    for k in range(18):
        out = out + (x >= (1 << k)).astype(x.dtype)
    return out


def _take_small(tab, idx, k: int):
    """tab[idx] for a tiny table (k entries) as a masked select-sum of
    k fused vector ops instead of a per-element gather."""
    import jax.numpy as jnp
    out = jnp.zeros(idx.shape, tab.dtype)
    for i in range(k):
        out = jnp.where(idx == i, tab[i], out)
    return out


def _perm_rows(x, perm):
    """x[:, perm] with a STATIC permutation (fast shuffle, not a dynamic
    gather)."""
    return x[:, perm]


def _rdoq_batch(co, lam, qp, size: int, scan_sel, trd, luma: bool, ebt,
                bit_inc: int, static_scan=None):
    """Vectorized RDOQ over a TU batch — xRateDistOptQuant
    (TComTrQuant.cpp:1719) with the sequential per-coefficient context
    chain (c1/c2/goRice/ctxSet) replaced by closed-form proxies computed
    from the pre-quant levels, and estBits frozen at slice-init states.
    Level choice, CG zero-out and the best-last-position scan follow the
    reference cost model exactly.

    co [N,s,s] int32 signed coefficients; scan_sel [N] in {0,1,2};
    trd [N] cbf-ctx transform depth.  static_scan: when every TU of the
    class uses one scan (diag for sizes >= 16), all permutations become
    static shuffles and table reads become masked selects instead of
    per-element gathers.  Returns (levels [N,s,s] signed, delta_u [N,s,s])."""
    import jax.numpy as jnp

    f32 = jnp.float32
    nb = co.shape[0]
    p = size * size
    ncg = p // 16
    log2 = size.bit_length() - 1
    BIG = f32(3e38)

    sigmap_np, rgt_np, low_np, glx, gly, gep = _rdoq_tables(size, luma)
    scan_np = _scan_tables(size)

    per = qp // 6
    rem = qp % 6
    uiQ = jnp.asarray(rom.QUANT_SCALES, jnp.int32)[rem]
    ts = 15 - (8 + bit_inc) - log2
    qbits = 14 + per + ts
    err_scale = (f32(1 << 15) * f32(2.0 ** (-2 * ts))
                 / uiQ.astype(f32) / uiQ.astype(f32)
                 / f32(1 << (2 * bit_inc)))
    lam = lam.astype(f32)

    flat = co.reshape(nb, p)
    if static_scan is not None:
        sflat = _perm_rows(flat, scan_np[static_scan])
    else:
        pos = jnp.asarray(scan_np)[scan_sel]        # [N, P] raster pos
        sflat = jnp.take_along_axis(flat, pos, axis=1)
    a_s = jnp.abs(sflat)
    sgn = jnp.where(sflat < 0, -1, 1)
    ld = a_s * uiQ
    half = jnp.int32(1) << (qbits - 1)
    maxab = (ld + half) >> qbits

    p_idx = jnp.arange(p, dtype=jnp.int32)[None, :]
    last = jnp.max(jnp.where(maxab > 0, p_idx, -1), axis=1)     # [N]
    has_any = last >= 0
    cg_of_last = jnp.maximum(last, 0) // 16
    in_coded = p_idx <= last[:, None]
    is_last = p_idx == last[:, None]

    # ---- proxy context chain (within-CG reversed cumulative counts) ----
    def above(x):
        x3 = x.reshape(nb, ncg, 16).astype(jnp.int32)
        inc = jnp.cumsum(x3[..., ::-1], axis=-1)[..., ::-1]
        return (inc - x3).reshape(nb, p)

    ge1 = maxab >= 1
    ge2 = maxab >= 2
    n1 = above(ge1)
    n2 = above(ge2)
    n3 = above(maxab > 3)
    c1_idx = jnp.minimum(n1, 8)
    c2_idx = jnp.minimum(n2, 1)
    c1 = jnp.where(n2 > 0, 0, jnp.minimum(1 + (n1 - n2), 3))
    rice = jnp.minimum(n3, 4)

    g_idx = jnp.arange(ncg, dtype=jnp.int32)[None, :]
    cg_ge2 = ge2.reshape(nb, ncg, 16).any(axis=2)
    prev_ge2 = jnp.concatenate(
        [cg_ge2[:, 1:], jnp.zeros((nb, 1), bool)], axis=1)
    prev_valid = (g_idx + 1) <= cg_of_last[:, None]
    ctx_set = ((2 if luma else 0) * (g_idx > 0).astype(jnp.int32)
               + (prev_ge2 & prev_valid).astype(jnp.int32))   # [N, ncg]
    ctx_set_p = jnp.repeat(ctx_set, 16, axis=1)
    ctx_one = 4 * ctx_set_p + c1
    ctx_abs = ctx_set_p + jnp.minimum(n2, 2)

    # significance context from the neighbor-CG pattern proxy
    cg_has = ge1.reshape(nb, ncg, 16).any(axis=2)
    cg_has_pad = jnp.concatenate(
        [cg_has, jnp.zeros((nb, 1), bool)], axis=1)
    if static_scan is not None:
        r_sig = _perm_rows(cg_has_pad, rgt_np[static_scan])
        l_sig = _perm_rows(cg_has_pad, low_np[static_scan])
    else:
        rgt = jnp.asarray(rgt_np)
        low = jnp.asarray(low_np)
        r_sig = jnp.take_along_axis(cg_has_pad, rgt[scan_sel], axis=1)
        l_sig = jnp.take_along_axis(cg_has_pad, low[scan_sel], axis=1)
    patt = r_sig.astype(jnp.int32) + 2 * l_sig.astype(jnp.int32)
    patt_p = jnp.repeat(patt, 16, axis=1)                     # [N, P]
    # sig-flag bits per (pattern, position) — precomputed vectors shipped
    # in ebt (sig0p/sig1p [3, 4, P]); masked select instead of gather
    sig0 = jnp.zeros((nb, p), f32)
    sig1 = jnp.zeros((nb, p), f32)
    for pat in range(4):
        msk = patt_p == pat
        if static_scan is not None:
            v0 = ebt["sig0p"][static_scan, pat]
            v1 = ebt["sig1p"][static_scan, pat]
            sig0 = jnp.where(msk, v0[None, :], sig0)
            sig1 = jnp.where(msk, v1[None, :], sig1)
        else:
            v0 = ebt["sig0p"][scan_sel[:, None],
                              jnp.full_like(scan_sel, pat)[:, None],
                              p_idx]
            v1 = ebt["sig1p"][scan_sel[:, None],
                              jnp.full_like(scan_sel, pat)[:, None],
                              p_idx]
            sig0 = jnp.where(msk, v0, sig0)
            sig1 = jnp.where(msk, v1, sig1)

    # ---- level decision (xGetCodedLevel + xGetICRateCost) ----
    base_level = jnp.where(c1_idx < 8, 2 + (c2_idx < 1).astype(jnp.int32),
                           1)
    n_one = 16 if luma else 8
    n_abs = 4 if luma else 2
    one0 = _take_small(ebt["one"][:, 0].astype(f32), ctx_one, n_one)
    one1 = _take_small(ebt["one"][:, 1].astype(f32), ctx_one, n_one)
    abs0 = _take_small(ebt["abs_"][:, 0].astype(f32), ctx_abs, n_abs)
    abs1 = _take_small(ebt["abs_"][:, 1].astype(f32), ctx_abs, n_abs)

    def ic_rate(lv):
        sym = lv - base_level
        small = sym < (3 << rice)
        r_small = (((sym >> rice) + 1 + rice) << 15).astype(f32)
        t = jnp.maximum(sym - (3 << rice), 0) + (1 << rice)
        ln = _bitlen(t) - 1
        r_big = ((3 + ln + 1 - rice + ln) << 15).astype(f32)
        r_ge = (jnp.where(small, r_small, r_big)
                + jnp.where(c1_idx < 8,
                            one1 + jnp.where(c2_idx < 1, abs1, 0.0), 0.0))
        rate = jnp.where(lv >= base_level, r_ge,
                         jnp.where(lv == 1, one0,
                                   jnp.where(lv == 2, one1 + abs0, 0.0)))
        return rate + f32(1 << 15)          # sign bit (IEP_RATE)

    esf = err_scale
    cost0 = ld.astype(f32) * ld.astype(f32) * esf
    sig_term = jnp.where(is_last, 0.0, lam * sig1)

    def lvl_cost(lv):
        err = (ld - (lv << qbits)).astype(f32)
        return err * err * esf + lam * ic_rate(lv) + sig_term

    m = maxab
    cm = jnp.where(m >= 1, lvl_cost(m), BIG)
    cm1 = jnp.where(m >= 2, lvl_cost(jnp.maximum(m - 1, 1)), BIG)
    czero = jnp.where((m < 3) & ~is_last, cost0 + lam * sig0, BIG)
    # HM order: zero baseline, then m (strict <), then m-1 (strict <)
    lvl = jnp.zeros_like(m)
    best = czero
    take_m = cm < best
    lvl = jnp.where(take_m, m, lvl)
    best = jnp.minimum(best, cm)
    take_m1 = cm1 < best
    lvl = jnp.where(take_m1, m - 1, lvl)
    best = jnp.minimum(best, cm1)
    # outside the coded region: uncoded
    lvl = jnp.where(in_coded, lvl, 0)
    cost_coeff = jnp.where(in_coded, best, cost0)
    cost_sig = jnp.where(
        in_coded,
        jnp.where(is_last, 0.0,
                  jnp.where(lvl > 0, lam * sig1, lam * sig0)),
        0.0)

    # ---- CG zero-out (sigCoeffGroupFlag RD) ----
    lvl3 = lvl.reshape(nb, ncg, 16)
    cc3 = cost_coeff.reshape(nb, ncg, 16)
    cs3 = cost_sig.reshape(nb, ncg, 16)
    c03 = cost0.reshape(nb, ncg, 16)
    nz3 = lvl3 > 0
    dec_sig = nz3.any(axis=2)
    sum_cc = cc3.sum(axis=2)
    sum_sig = cs3.sum(axis=2)
    coded_ld = jnp.where(nz3, cc3 - cs3, 0.0).sum(axis=2)
    unc_nz = jnp.where(nz3, c03, 0.0).sum(axis=2)
    nnz_b4 = nz3[:, :, 1:].sum(axis=2)
    sig_pos0 = cs3[:, :, 0]

    cg_in = g_idx <= cg_of_last[:, None]
    is_lastcg = g_idx == cg_of_last[:, None]
    is_cg0 = g_idx == 0
    eligible = cg_in & ~is_lastcg & ~is_cg0 & dec_sig
    adj = eligible & (nnz_b4 == 0)
    sum_sig_adj = jnp.where(adj, sum_sig - sig_pos0, sum_sig)

    # sigCG context from decided-neighbor proxy
    dec_pad = jnp.concatenate([dec_sig, jnp.zeros((nb, 1), bool)], axis=1)
    if static_scan is not None:
        cg_r = _perm_rows(dec_pad, rgt_np[static_scan])
        cg_l = _perm_rows(dec_pad, low_np[static_scan])
    else:
        cg_r = jnp.take_along_axis(dec_pad, rgt[scan_sel], axis=1)
        cg_l = jnp.take_along_axis(dec_pad, low[scan_sel], axis=1)
    cg_ctx = cg_r | cg_l
    cg0b = jnp.where(cg_ctx, ebt["cg"][1, 0], ebt["cg"][0, 0]).astype(f32)
    cg1b = jnp.where(cg_ctx, ebt["cg"][1, 1], ebt["cg"][0, 1]).astype(f32)

    zero_cost = lam * cg0b + unc_nz - coded_ld - sum_sig_adj
    zeroed = eligible & (zero_cost < lam * cg1b)
    empty = cg_in & ~is_lastcg & ~is_cg0 & ~dec_sig
    drop = zeroed | empty
    lvl3 = jnp.where(drop[:, :, None], 0, lvl3)
    cc3 = jnp.where(drop[:, :, None], c03, cc3)
    cs3 = jnp.where(drop[:, :, None], 0.0, cs3)
    cost_cg_sig = jnp.where(zeroed | empty, lam * cg0b,
                            jnp.where(eligible & ~zeroed, lam * cg1b,
                                      0.0))
    cost_cg_sig = jnp.where(cg_in, cost_cg_sig, 0.0)

    lvl = lvl3.reshape(nb, p)
    cost_coeff = cc3.reshape(nb, p)
    cost_sig = cs3.reshape(nb, p)

    # ---- best last position (TComTrQuant.cpp:2096-2177) ----
    if luma:
        cbf_ctx = jnp.where(trd == 0, 1, 0)
    else:
        cbf_ctx = 5 + trd
    cbf0 = _take_small(ebt["cbp"][:, 0].astype(f32), cbf_ctx, 10)
    cbf1 = _take_small(ebt["cbp"][:, 1].astype(f32), cbf_ctx, 10)
    base_final = (cost_coeff.sum(axis=1)
                  - jnp.where(adj, sig_pos0, 0.0).sum(axis=1)
                  + cost_cg_sig.sum(axis=1) + lam * cbf1)
    best0 = cost0.sum(axis=1) + lam * cbf0

    nzp = lvl > 0
    d = jnp.where(in_coded, jnp.where(nzp, cost_coeff - cost0, cost_sig),
                  0.0)
    # exclusive suffix sum over scan positions
    suf_d = (jnp.cumsum(d[:, ::-1], axis=1)[:, ::-1] - d)
    sufD_cg = jnp.cumsum(cost_cg_sig[:, ::-1], axis=1)[:, ::-1]  # incl
    sufD_p = jnp.repeat(sufD_cg, 16, axis=1)
    if static_scan is not None:
        rate_last = ebt["rlv"][static_scan][None, :]
    else:
        rate_last = ebt["rlv"][scan_sel, :]
    total = (base_final[:, None] - sufD_p - suf_d
             + lam * rate_last - cost_sig)
    gt1_pos = jnp.max(jnp.where(lvl > 1, p_idx, 0), axis=1)
    cand = nzp & in_coded & (p_idx >= gt1_pos[:, None])
    total = jnp.where(cand, total, BIG)
    tmin = jnp.min(total, axis=1)
    # tie-break toward the LARGER scan position (walk order)
    pick = jnp.max(jnp.where(total == tmin[:, None], p_idx, -1), axis=1)
    keep_any = (tmin < best0) & has_any
    last_p1 = jnp.where(keep_any, pick + 1, 0)
    lvl = jnp.where(p_idx < last_p1[:, None], lvl, 0)

    du = jnp.where(in_coded, (ld - (lvl << qbits)) >> (qbits - 8), 0)

    if static_scan is not None:
        inv = np.empty(p, np.int64)
        inv[scan_np[static_scan]] = np.arange(p)
        out = _perm_rows(lvl * sgn, inv)
        duo = _perm_rows(du, inv)
    else:
        out = jnp.zeros((nb, p), jnp.int32)
        out = out.at[jnp.arange(nb)[:, None], pos].set(lvl * sgn)
        duo = jnp.zeros((nb, p), jnp.int32)
        duo = duo.at[jnp.arange(nb)[:, None], pos].set(du)
    return out.reshape(nb, size, size), duo.reshape(nb, size, size)


def _sbh_batch(levels, src, du, scan_sel, size: int, static_scan=None):
    """Vectorized signBitHidingHDQ (mirror of codec_core.cpp sbh_hdq_c /
    TComTrQuant.cpp:977) over a TU batch.

    levels/src/du [N, s, s] raster; scan_sel [N] in {0,1,2} selecting the
    scan table (static_scan: one static scan for the whole class).
    Returns adjusted levels.
    """
    import jax.numpy as jnp

    # costs are |delta_u| < 2^8 (quant remainder >> (qbits-8)); the
    # sentinel must survive the *16 tie-break key in int32
    INF = jnp.int32(1) << 26
    nb = levels.shape[0]
    p = size * size
    ncg = p // 16
    scan_np = _scan_tables(size)                      # [3, p]
    if static_scan is not None:
        perm = scan_np[static_scan]
        lv = _perm_rows(levels.reshape(nb, p), perm)
        sr = _perm_rows(src.reshape(nb, p), perm)
        dd = _perm_rows(du.reshape(nb, p), perm)
    else:
        pos = jnp.asarray(scan_np)[scan_sel]          # [N, p]
        lv = jnp.take_along_axis(levels.reshape(nb, p), pos, axis=1)
        sr = jnp.take_along_axis(src.reshape(nb, p), pos, axis=1)
        dd = jnp.take_along_axis(du.reshape(nb, p), pos, axis=1)
    lv = lv.reshape(nb, ncg, 16)
    sr = sr.reshape(nb, ncg, 16)
    dd = dd.reshape(nb, ncg, 16).astype(jnp.int32)

    nz = lv != 0
    any_nz = nz.any(axis=2)                           # [N, ncg]
    n_idx = jnp.arange(16, dtype=jnp.int32)
    first_nz = jnp.min(jnp.where(nz, n_idx, 99), axis=2)
    last_nz = jnp.max(jnp.where(nz, n_idx, -1), axis=2)
    g_idx = jnp.arange(ncg, dtype=jnp.int32)
    last_cg = jnp.max(jnp.where(any_nz, g_idx, -1), axis=1)   # [N]
    start_n = jnp.where(g_idx[None, :] == last_cg[:, None], last_nz, 15)

    csum = jnp.sum(jnp.where((n_idx[None, None] >= first_nz[..., None])
                             & (n_idx[None, None] <= last_nz[..., None]),
                             lv, 0), axis=2)
    fsel = jnp.minimum(first_nz, 15)[..., None] == n_idx[None, None]
    lv_first = jnp.sum(jnp.where(fsel, lv, 0), axis=2)
    signbit = jnp.where(lv_first > 0, 0, 1)
    need = (last_nz - first_nz >= 4) & (signbit != (csum & 1))

    # per-position candidate cost + change (sbh_hdq_c rules)
    q = lv
    is_first = n_idx[None, None] == first_nz[..., None]
    abs1 = jnp.abs(q) == 1
    cost_nzpos = jnp.where(dd > 0, -dd,
                           jnp.where(is_first & abs1, INF, dd))
    chg_nzpos = jnp.where(dd > 0, 1, jnp.where(is_first & abs1, 0, -1))
    before_first = n_idx[None, None] < first_nz[..., None]
    sign_src = jnp.where(sr >= 0, 0, 1)
    bad_sign = before_first & (sign_src != signbit[..., None])
    cost_zpos = jnp.where(bad_sign, INF, -dd)
    chg_zpos = jnp.where(bad_sign, 0, 1)
    cost = jnp.where(q != 0, cost_nzpos, cost_zpos)
    chg = jnp.where(q != 0, chg_nzpos, chg_zpos)
    cost = jnp.where(n_idx[None, None] > start_n[..., None], INF, cost)
    # tie-break: the C scan runs n from start_n DOWN to 0 with a strict
    # compare, keeping the LARGEST n among equal costs
    key = cost * 16 + (15 - n_idx[None, None])
    sel = jnp.argmin(key, axis=2)                     # [N, ncg]
    ssel = sel[..., None] == n_idx[None, None]
    sel_chg = jnp.sum(jnp.where(ssel, chg, 0), axis=2)
    sel_q = jnp.sum(jnp.where(ssel, q, 0), axis=2)
    sel_src = jnp.sum(jnp.where(ssel, sr, 0), axis=2)
    sel_chg = jnp.where((sel_q == 32767) | (sel_q == -32768), -1, sel_chg)
    delta = jnp.where(sel_src >= 0, sel_chg, -sel_chg)
    delta = jnp.where(need, delta, 0)
    lv = lv + jnp.where(n_idx[None, None] == sel[..., None], delta[..., None],
                        0)

    if static_scan is not None:
        inv = np.empty(p, np.int64)
        inv[scan_np[static_scan]] = np.arange(p)
        out = _perm_rows(lv.reshape(nb, p), inv)
    else:
        out = jnp.zeros((nb, p), levels.dtype)
        out = out.at[jnp.arange(nb)[:, None], pos].set(lv.reshape(nb, p))
    return out.reshape(nb, size, size)


def _class_step(state, org_wins, flat_dev, off, w, ci, cap, qp, lam, ebt,
                bit_inc, max_val, sign_hide, use_rdoq):
    """One wave step for one size class: gather refs from the evolving
    recon plane, predict, transform + RDOQ (or quant) + SBH,
    reconstruct, scatter recon; levels land in a flat per-record output
    (contiguous dynamic_update_slice — the frame-layout assembly happens
    on the host)."""
    import jax
    import jax.numpy as jnp
    from ..ops import jx

    size, luma, use_dst = CLS[ci]
    s = size
    unit = 4 if luma else 2
    L = 4 * s + unit
    # one static scan per class for sizes >= 16 (diag, index 2): all
    # permutations become static shuffles, not per-element gathers
    static_scan = 2 if s >= 16 else None
    rec, out_lv = state
    xs, ys, lo, hi, mode, scan = flat_dev
    start = jax.lax.dynamic_slice(off, (w,), (1,))[0]
    x0 = jax.lax.dynamic_slice(xs, (start,), (cap,))
    y0 = jax.lax.dynamic_slice(ys, (start,), (cap,))
    lo_ = jax.lax.dynamic_slice(lo, (start,), (cap,))
    hi_ = jax.lax.dynamic_slice(hi, (start,), (cap,))
    md = jax.lax.dynamic_slice(mode, (start,), (cap,))
    sc = jax.lax.dynamic_slice(scan, (start,), (cap,))
    owin = jax.lax.dynamic_slice(
        org_wins, (start, 0, 0), (cap, s, s)).astype(jnp.int32)

    # reference line via two WINDOWED gathers (vmapped dynamic_slice
    # lowers to slice-gathers, not per-element gathers): the left+corner
    # column and the top row, raw; HM's unavailable-sample substitution
    # over a contiguous range is then just boundary replication —
    # samples below lo take line[lo], above hi take line[hi]
    colw = jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(rec, (y, x), (2 * s + 1, 1))
    )(y0, x0)[:, :, 0].astype(jnp.int32)          # [N, 2s+1] corner+left
    topw = jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(rec, (y, x), (1, 2 * s))
    )(y0, x0 + 1)[:, 0, :].astype(jnp.int32)      # [N, 2s] top row
    corner0 = colw[:, 0:1]
    left_desc = colw[:, 1:][:, ::-1]              # line[0..2s-1]
    line = jnp.concatenate(
        [left_desc, jnp.repeat(corner0, unit, axis=1), topw], axis=1)
    i = jnp.arange(L, dtype=jnp.int32)[None, :]
    v_lo = jnp.take_along_axis(line, lo_[:, None], axis=1)
    v_hi = jnp.take_along_axis(line, hi_[:, None], axis=1)
    line = jnp.where(i < lo_[:, None], v_lo, line)
    line = jnp.where(i > hi_[:, None], v_hi, line)
    dc_fill = 1 << (7 + bit_inc)
    none_avail = (lo_ > hi_)[:, None]
    line = jnp.where(none_avail, dc_fill, line)
    corner = line[:, 2 * s][:, None]
    ra = jnp.concatenate([corner, line[:, 2 * s + unit:]], axis=1)
    rl = jnp.concatenate([corner, line[:, 2 * s - 1::-1][:, :2 * s]],
                         axis=1)

    pred = _predict_batch(ra, rl, s, luma, md, max_val)

    resi = owin - pred
    co = jx.forward_transform(resi, use_dst, bit_inc)
    qp_vec = jnp.full((cap,), qp, jnp.int32)
    scan_sel = jnp.clip((sc & 3) - 1, 0, 2)
    if use_rdoq:
        levels, du = _rdoq_batch(co, lam, qp, s, scan_sel, sc >> 2,
                                 luma, ebt, bit_inc, static_scan)
    else:
        levels, du = jx.quant(co, qp_vec, True, bit_inc)
    if sign_hide:
        levels = _sbh_batch(levels, co, du, scan_sel, s, static_scan)
    deq = jx.dequant(levels, qp_vec, bit_inc)
    rres = jx.inverse_transform(deq, use_dst, bit_inc)
    recb = jnp.clip(pred + rres, 0, max_val)

    # windowed scatter (block copies, not per-element scatter): TU
    # regions are disjoint by construction
    dn = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1, 2), inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0, 1))
    idx = jnp.stack([y0 + 1, x0 + 1], axis=1)
    rec = jax.lax.scatter(rec, idx, recb.astype(rec.dtype), dn,
                          indices_are_sorted=False, unique_indices=False)
    out_lv = jax.lax.dynamic_update_slice(
        out_lv, levels.astype(out_lv.dtype), (start, 0, 0))
    return rec, out_lv


def _apply_body(org_wins, org_wins_cr, flats, offs, n_waves, qps, lams,
                ebts, statics):
    import jax
    import jax.numpy as jnp

    (hp, wp, bit_inc, max_val, sign_hide, use_rdoq, caps) = statics
    qp_y, qp_cb, qp_cr = qps[0], qps[1], qps[2]
    lam_y, lam_c = lams[0], lams[1]

    i16 = jnp.int16
    rec_y = jnp.zeros((hp + 1 + GUARD, wp + 1 + GUARD), i16)
    rec_cb = jnp.zeros((hp // 2 + 1 + GUARD, wp // 2 + 1 + GUARD), i16)
    rec_cr = jnp.zeros_like(rec_cb)
    # flat per-record level outputs (org_wins layout; the host assembles
    # the frame-shaped coefficient planes from these)
    lvs = [jnp.zeros(org_wins[ci].shape, i16) for ci in range(len(CLS))]
    lvs_cr = [jnp.zeros(org_wins_cr[ci].shape, i16)
              if org_wins_cr[ci] is not None else None
              for ci in range(len(CLS))]

    def body(w, carry):
        rec_y, rec_cb, rec_cr, lvs, lvs_cr = carry
        lvs = list(lvs)
        lvs_cr = list(lvs_cr)
        for ci in range(len(CLS)):
            size, luma, _ = CLS[ci]
            cnt = offs[ci][w + 1] - offs[ci][w]

            if luma:
                def run(ops, ci=ci):
                    rec_y, lv = ops
                    return _class_step(
                        (rec_y, lv), org_wins[ci], flats[ci], offs[ci],
                        w, ci, caps[ci], qp_y, lam_y, ebts[ci], bit_inc,
                        max_val, sign_hide, use_rdoq)

                rec_y, lvs[ci] = jax.lax.cond(
                    cnt > 0, run, lambda o: o, (rec_y, lvs[ci]))
            else:
                def run_c(ops, ci=ci):
                    rec_cb, rec_cr, lv, lvc = ops
                    rec_cb, lv = _class_step(
                        (rec_cb, lv), org_wins[ci], flats[ci], offs[ci],
                        w, ci, caps[ci], qp_cb, lam_c, ebts[ci], bit_inc,
                        max_val, sign_hide, use_rdoq)
                    rec_cr, lvc = _class_step(
                        (rec_cr, lvc), org_wins_cr[ci], flats[ci],
                        offs[ci], w, ci, caps[ci], qp_cr, lam_c,
                        ebts[ci], bit_inc, max_val, sign_hide, use_rdoq)
                    return rec_cb, rec_cr, lv, lvc

                rec_cb, rec_cr, lvs[ci], lvs_cr[ci] = jax.lax.cond(
                    cnt > 0, run_c, lambda o: o,
                    (rec_cb, rec_cr, lvs[ci], lvs_cr[ci]))
        return rec_y, rec_cb, rec_cr, tuple(lvs), tuple(lvs_cr)

    carry = (rec_y, rec_cb, rec_cr, tuple(lvs),
             tuple(v for v in lvs_cr))
    carry = jax.lax.fori_loop(0, n_waves, body, carry)
    rec_y, rec_cb, rec_cr, lvs, lvs_cr = carry
    # 8-bit content is fetched as uint8 (halves the recon fetch)
    rt = jnp.uint8 if max_val <= 255 else i16
    return (rec_y[1:1 + hp, 1:1 + wp].astype(rt),
            rec_cb[1:1 + hp // 2, 1:1 + wp // 2].astype(rt),
            rec_cr[1:1 + hp // 2, 1:1 + wp // 2].astype(rt),
            lvs, lvs_cr)


_apply_cache = {}


def _apply_fn(statics):
    import jax
    fn = _apply_cache.get(statics)
    if fn is None:
        fn = jax.jit(partial(_apply_body, statics=statics))
        _apply_cache[statics] = fn
    return fn


def run_device_apply(org_y, org_cb, org_cr, sched: Schedule, width, height,
                     qp_y, qp_cb, qp_cr, ctu_size, bit_inc, max_val,
                     sign_hide, use_rdoq=False, lam_y=1.0, lam_c=1.0,
                     init_ctx=None, device=None):
    """Dispatch the wavefront apply for one frame; returns a token for
    collect_device_apply (device computes asynchronously)."""
    import jax
    import jax.numpy as jnp
    from .fast_intra import _decision_device

    if device is None:
        device = _decision_device()
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size

    oy = np.asarray(org_y, np.int16)
    ocb = np.asarray(org_cb, np.int16)
    ocr = np.asarray(org_cr, np.int16)

    # per-record source windows, extracted host-side (the source is
    # static, so the in-loop read becomes a CONTIGUOUS dynamic_slice
    # instead of a serializing 2-D gather)
    def windows(plane, ci):
        s = CLS[ci][0]
        xs, ys = sched.flat[ci][0], sched.flat[ci][1]
        n_c = sched.counts[ci]
        out = np.zeros((len(xs), s, s), np.int16)
        if n_c:
            dy = np.arange(s)
            out[:n_c] = plane[ys[:n_c, None, None] + dy[None, :, None],
                              xs[:n_c, None, None] + dy[None, None, :]]
        return out

    put = partial(jax.device_put, device=device)
    org_wins = tuple(put(windows(oy if CLS[ci][1] else ocb, ci))
                     for ci in range(len(CLS)))
    org_wins_cr = tuple(None if CLS[ci][1] else put(windows(ocr, ci))
                        for ci in range(len(CLS)))
    flats = tuple(tuple(put(a) for a in f) for f in sched.flat)
    offs = tuple(put(o) for o in sched.offs)
    qps = put(np.asarray([qp_y, qp_cb, qp_cr], np.int32))
    lams = put(np.asarray([lam_y, lam_c], np.float32))
    if use_rdoq:
        assert init_ctx is not None
        ebts = tuple(
            {k: put(v) for k, v in
             est_bits_pack(init_ctx, CLS[ci][0], CLS[ci][1]).items()}
            for ci in range(len(CLS)))
    else:
        ebts = tuple({} for _ in range(len(CLS)))
    statics = (hp, wp, int(bit_inc), int(max_val), bool(sign_hide),
               bool(use_rdoq), tuple(sched.caps))
    fn = _apply_fn(statics)
    out = fn(org_wins, org_wins_cr, flats, offs,
             jnp.int32(sched.n_waves), qps, lams, ebts)
    from ..ops.device import stat_launch
    stat_launch(oy.nbytes + ocb.nbytes + ocr.nbytes, device=device)
    return out


def collect_device_apply(token):
    """Block on a dispatched apply: returns (rec_y, rec_cb, rec_cr,
    per-class level stacks, per-class cr level stacks) as numpy."""
    rec_y, rec_cb, rec_cr, lvs, lvs_cr = token
    return (np.asarray(rec_y), np.asarray(rec_cb), np.asarray(rec_cr),
            tuple(np.asarray(v) for v in lvs),
            tuple(None if v is None else np.asarray(v) for v in lvs_cr))


def assemble_coeff_planes(sched: Schedule, lvs, lvs_cr, f) -> None:
    """Scatter the flat per-record level stacks into the frame-shaped
    coefficient planes (vectorized numpy; record coords are the wave-
    sorted schedule order)."""
    for ci in range(len(CLS)):
        s, luma, _ = CLS[ci]
        n_c = sched.counts[ci]
        if not n_c:
            continue
        xs = sched.flat[ci][0][:n_c]
        ys = sched.flat[ci][1][:n_c]
        dy = np.arange(s)
        yy = ys[:, None, None] + dy[None, :, None]
        xx = xs[:, None, None] + dy[None, None, :]
        if luma:
            f.coeff_y[yy, xx] = lvs[ci][:n_c]
        else:
            f.coeff_cb[yy, xx] = lvs[ci][:n_c]
            f.coeff_cr[yy, xx] = lvs_cr[ci][:n_c]


# wall-clock per stage, accumulated across frames (bench reads + resets;
# guarded by the GIL — the frame-parallel thread pool updates are atomic
# enough for profiling)
stage_stats = {"sched": 0.0, "launch": 0.0, "fetch": 0.0, "fill": 0.0,
               "counter": 0.0, "cabac": 0.0, "frames": 0}


def stats_reset():
    out = dict(stage_stats)
    for k in stage_stats:
        stage_stats[k] = 0.0 if k != "frames" else 0
    return out


def device_apply_frame(cu, fd, qp_cb_scaled, qp_cr_scaled, nat) -> bool:
    """Full device apply for the current (intra) slice: schedule, launch,
    fetch, frame-array fill.  Returns False when the host fallback must
    run instead (schedule rejected the frame)."""
    import time
    f = cu.f
    sps = cu.sps
    t0 = time.time()
    sched = build_schedule(
        fd[0], fd[1], fd[2], fd[3], f.width, f.height, f.ctu_size,
        f.max_depth - sps.add_cu_depth, sps.quadtree_tu_log2_min_size)
    if sched is None:
        return False
    use_rdoq = bool(cu.cfg.get("RDOQ", 1))
    init_ctx = None
    if use_rdoq:
        from ..cabac import contexts as cc
        from .slice_encoder import enc_init_type
        init_ctx = cc.make_context_states_idx(
            enc_init_type(cu.sh, cu.pps), cu.sh.slice_qp)
    t1 = time.time()
    token = run_device_apply(
        cu.org_y, cu.org_cb, cu.org_cr, sched, f.width, f.height,
        cu.sh.slice_qp + sps.qp_bd_offset_y, qp_cb_scaled, qp_cr_scaled,
        f.ctu_size, sps.bit_increment, (1 << sps.internal_bit_depth) - 1,
        bool(cu.pps.sign_hide_flag), use_rdoq=use_rdoq,
        lam_y=cu.lambda_luma, lam_c=cu.lambda_chroma, init_ctx=init_ctx)
    t2 = time.time()
    rec_y, rec_cb, rec_cr, lvs, lvs_cr = collect_device_apply(token)
    t3 = time.time()
    h, w = f.height, f.width
    cu.rec_y[:h, :w] = rec_y[:h, :w]
    cu.rec_cb[:h // 2, :w // 2] = rec_cb[:h // 2, :w // 2]
    cu.rec_cr[:h // 2, :w // 2] = rec_cr[:h // 2, :w // 2]
    assemble_coeff_planes(sched, lvs, lvs_cr, f)
    nat.fill_from_fd()
    t4 = time.time()
    stage_stats["sched"] += t1 - t0
    stage_stats["launch"] += t2 - t1
    stage_stats["fetch"] += t3 - t2
    stage_stats["fill"] += t4 - t3
    stage_stats["frames"] += 1
    cu._dev_applied = True
    return True


def enabled() -> bool:
    """Device apply policy.  Off by default: the wavefront loop runs
    ~500 sequential device steps per 1080p frame, and whether it beats
    the host native apply on the GPU has not been measured yet.
    "1" enables it when the device path is on; "force" runs it on
    CPU-jax too (tests)."""
    from ..ops.device import device_enabled
    v = os.environ.get("THEVC_FASTRD_DEVAPPLY", "0")
    if v == "0":
        return False
    if v == "force":
        return True
    return device_enabled()
