"""Reconstruction driver: batched residual transform + ordered
prediction/add over the CU decode order.

Behavioral reference: TDecCu.cpp xReconIntraQT (:689) / xIntraRecLumaBlk
(:469) / xIntraRecChromaBlk (:534) / xReconPCM (:892) / xReconInter (:648)
/ xDecodeInterTexture (:778).

Structure for the device path: stage 1 (dequant + inverse transform of every
TU) is embarrassingly parallel over TUs of equal size — it runs as batched
matmul kernels on device, as does motion compensation (independent PUs).
Stage 2 (prediction + add) carries the intra neighbor dependency and walks
CUs in decode order; on the host it is a numpy loop (or the native
walk) that is bit-exact.
"""

from __future__ import annotations

import numpy as np

from ..common import rom
from ..common import scaling as scaling_mod
from ..ops import intra as intra_ops
from ..ops import transforms as tops
from ..params import Pps, SliceHeader, Sps
from .frame import DM_CHROMA_IDX, MODE_INTRA, SIZE_NxN, FrameModel


def _tu_availability_flags(f: FrameModel, ux: int, uy: int, num_units: int) -> np.ndarray:
    """Neighbor availability flags for a TU whose top-left luma unit is
    (ux, uy) and which spans num_units 4x4 units per edge.

    Layout (TComPattern::initAdiPattern): flags[0..nu-1] below-left
    (bottom-most first), flags[nu..2nu-1] left, flags[2nu] corner,
    flags[2nu+1..3nu] above, flags[3nu+1..4nu] above-right.
    """
    nu = num_units
    flags = np.zeros(4 * nu + 1, bool)
    flags[2 * nu] = f.available(ux - 1, uy - 1, ux, uy)
    for j in range(2 * nu):
        # left (j < nu) then below-left: unit at row uy + j
        flags[2 * nu - 1 - j] = f.available(ux - 1, uy + j, ux, uy)
    for j in range(2 * nu):
        flags[2 * nu + 1 + j] = f.available(ux + j, uy - 1, ux, uy)
    return flags


class _AvailCtx:
    """Vectorized neighbor availability: padded per-unit decode-order /
    slice / tile maps so a TU's whole flag vector is a handful of slice
    comparisons instead of per-unit Python calls (FrameModel.available)."""

    _PAD = 34  # > 2 * (64 / 4) units
    _GEOM_CACHE: dict = {}

    def __init__(self, f: FrameModel):
        self.f = f
        # the padded maps depend only on picture geometry + tile layout —
        # cache them across pictures (they were ~10% of decode wall time)
        t = f.tiles
        key = (f.depth.shape, f.units_per_row, f.width, f.height,
               None if t is None else
               (t.n_cols, t.n_rows, tuple(t.col_width), tuple(t.row_height)))
        cached = self._GEOM_CACHE.get(key)
        if cached is not None:
            self.order, self.in_pic, self.ctu, self.tile = cached
            return
        upr = f.units_per_row
        uh, uw = f.depth.shape
        uy, ux = np.mgrid[0:uh, 0:uw]
        ctu = (uy // upr).astype(np.int64) * f.ctus_w + ux // upr
        z = f.r2z[(uy % upr) * upr + (ux % upr)]
        order = np.asarray(f.ctu_inv_order)[ctu] * f.parts_per_ctu + z
        in_pic = (ux * f.unit < f.width) & (uy * f.unit < f.height)

        P = self._PAD
        self.order = np.zeros((uh + 2 * P, uw + 2 * P), np.int64)
        self.order[P:P + uh, P:P + uw] = order
        self.in_pic = np.zeros((uh + 2 * P, uw + 2 * P), bool)
        self.in_pic[P:P + uh, P:P + uw] = in_pic
        self.ctu = np.full((uh + 2 * P, uw + 2 * P), -1, np.int64)
        self.ctu[P:P + uh, P:P + uw] = ctu
        self.tile = np.full((uh + 2 * P, uw + 2 * P), -2, np.int64)
        self.tile[P:P + uh, P:P + uw] = f.tile_idx
        if len(self._GEOM_CACHE) > 8:
            self._GEOM_CACHE.clear()
        self._GEOM_CACHE[key] = (self.order, self.in_pic, self.ctu,
                                 self.tile)

    def tu_flags(self, ux: int, uy: int, nu: int) -> np.ndarray:
        f = self.f
        P = self._PAD
        x, y = ux + P, uy + P
        cur_o = self.order[y, x]
        sstart = int(f.slice_start[uy, ux])
        cur_ctu = self.ctu[y, x]
        cur_tile = self.tile[y, x]
        flags = np.empty(4 * nu + 1, bool)

        col = slice(y - 1, y + 2 * nu)
        o = self.order[col, x - 1]
        ok = (self.in_pic[col, x - 1] & (o < cur_o) & (o >= sstart)
              & ((self.ctu[col, x - 1] == cur_ctu)
                 | (self.tile[col, x - 1] == cur_tile)))
        flags[2 * nu] = ok[0]
        flags[:2 * nu] = ok[1:][::-1]

        row = slice(x, x + 2 * nu)
        o = self.order[y - 1, row]
        flags[2 * nu + 1:] = (self.in_pic[y - 1, row] & (o < cur_o)
                              & (o >= sstart)
                              & ((self.ctu[y - 1, row] == cur_ctu)
                                 | (self.tile[y - 1, row] == cur_tile)))
        return flags


def _residual(coeff_block: np.ndarray, qp: int, use_dst: bool, ts: bool,
              bypass: bool, bit_inc: int) -> np.ndarray:
    if bypass:
        return coeff_block.astype(np.int32)
    deq = tops.dequant(coeff_block[None], qp, bit_inc)[0]
    if ts:
        return tops.transform_skip_inv(deq[None], bit_inc)[0].astype(np.int32)
    return tops.inverse_transform(deq[None], use_dst, bit_inc)[0].astype(np.int32)


def _collect_residuals_vec(f: FrameModel, sps: Sps, pps: Pps, runs,
                           groups: dict) -> bool:
    """Vectorized TU-batch builder for `_collect_residuals` (the per-TU
    Python loop was ~40% of device-path decode wall time at 1080p).
    Fills `groups` exactly like the scalar path; returns False when the
    frame shape doesn't fit the fast path (falls back to the loop)."""
    from ..common.rom import CHROMA_SCALE
    cs_tab = np.asarray(CHROMA_SCALE, np.int32)
    cu_all = np.asarray(f.cu_list, np.int64).reshape(-1, 8) \
        if len(f.cu_list) else np.zeros((0, 8), np.int64)
    lt_all = np.asarray(f.luma_tus, np.int64).reshape(-1, 6) \
        if len(f.luma_tus) else np.zeros((0, 6), np.int64)
    ct_all = np.asarray(f.chroma_tus, np.int64).reshape(-1, 6) \
        if len(f.chroma_tus) else np.zeros((0, 6), np.int64)

    for (sh, inter_pred, lo, hi) in runs:
        cu = cu_all[lo:hi]
        if len(cu) == 0:
            continue
        # TU index ranges of consecutive CUs must tile contiguously
        if not (np.all(cu[1:, 4] == cu[:-1, 5])
                and np.all(cu[1:, 6] == cu[:-1, 7])):
            return False
        l0, l1 = int(cu[0, 4]), int(cu[-1, 5])
        c0, c1 = int(cu[0, 6]), int(cu[-1, 7])
        lt = lt_all[l0:l1]
        ct = ct_all[c0:c1]
        mode_lt = np.repeat(cu[:, 3], (cu[:, 5] - cu[:, 4]))

        if len(lt):
            tx, ty, tsz, trd = lt[:, 0], lt[:, 1], lt[:, 2], lt[:, 5]
            ux, uy = tx >> 2, ty >> 2
            ok = ((f.cbf[0, uy, ux].astype(np.int64) >> trd) & 1) == 1
            ok &= ~f.ts_flag[0, uy, ux].astype(bool)
            ok &= ~f.tq_bypass[uy, ux].astype(bool)
            ok &= ~f.ipcm[uy, ux].astype(bool)
            qps = f.qp[uy, ux].astype(np.int32) + sps.qp_bd_offset_y
            dst = (tsz == 4) & (mode_lt == MODE_INTRA)
            for size in (4, 8, 16, 32):
                for use_dst in ((False, True) if size == 4 else (False,)):
                    m = ok & (tsz == size) & (dst == use_dst)
                    if not m.any():
                        continue
                    idx = np.nonzero(m)[0]
                    bx, by = tx[idx], ty[idx]
                    gy = by[:, None, None] + np.arange(size)[None, :, None]
                    gx = bx[:, None, None] + np.arange(size)[None, None, :]
                    blocks = f.coeff_y[gy, gx]
                    groups.setdefault((0, size, bool(use_dst)), []).append(
                        (bx, by, blocks, qps[idx]))

        if len(ct):
            cx, cy, csz, trd = ct[:, 0], ct[:, 1], ct[:, 2], ct[:, 5]
            ux, uy = cx >> 1, cy >> 1
            base_ok = ~f.tq_bypass[uy, ux].astype(bool)
            base_ok &= ~f.ipcm[uy, ux].astype(bool)
            qp_raw = f.qp[uy, ux].astype(np.int32)
            for comp, plane, qp_off in (
                    (1, f.coeff_cb,
                     pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb),
                    (2, f.coeff_cr,
                     pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr)):
                ok = base_ok.copy()
                ok &= ((f.cbf[comp, uy, ux].astype(np.int64) >> trd) & 1) == 1
                ok &= ~f.ts_flag[comp, uy, ux].astype(bool)
                q = np.clip(qp_raw + qp_off, -sps.qp_bd_offset_c, 57)
                qps = np.where(q < 0, q, cs_tab[np.maximum(q, 0)]) \
                    + sps.qp_bd_offset_c
                for size in (4, 8, 16):
                    m = ok & (csz == size)
                    if not m.any():
                        continue
                    idx = np.nonzero(m)[0]
                    bx, by = cx[idx], cy[idx]
                    gy = by[:, None, None] + np.arange(size)[None, :, None]
                    gx = bx[:, None, None] + np.arange(size)[None, None, :]
                    blocks = plane[gy, gx]
                    groups.setdefault((comp, size, False), []).append(
                        (bx, by, blocks, qps[idx]))
    return True


def _collect_residuals(f: FrameModel, sps: Sps, pps: Pps, runs) -> dict:
    """Stage 1 of the device decode path: gather every coded TU of the
    picture into per-(component, size, dst) batches and run dequant+IDCT
    as a handful of jx.residual_pipeline launches (SURVEY.md section 7).

    Returns {(comp, x, y): residual int32 array}.  Transform-skip and
    lossless-bypass TUs are left to the per-TU scalar path.
    """
    from ..ops import jx
    bit_inc = sps.bit_increment
    groups: dict = {}

    def add(comp, x, y, size, plane, qps):
        groups.setdefault((comp, size, False), []).append(
            ((comp, x, y), plane[y:y + size, x:x + size], qps))

    def add_dst(x, y, plane, qps):
        groups.setdefault((0, 4, True), []).append(
            ((0, x, y), plane[y:y + 4, x:x + 4], qps))

    if _collect_residuals_vec(f, sps, pps, runs, groups):
        return _launch_residuals(f, sps, groups)
    groups.clear()
    for (sh, inter_pred, lo, hi) in runs:
        qp_off = (pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb,
                  pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr)
        for (px, py, size, mode, l0, l1, c0, c1) in f.cu_list[lo:hi]:
            for (tx, ty, tsz, abs_part, ctu, trd) in f.luma_tus[l0:l1]:
                ux, uy = tx // 4, ty // 4
                if not (int(f.cbf[0, uy, ux]) >> trd) & 1:
                    continue
                if f.ts_flag[0, uy, ux] or f.tq_bypass[uy, ux] \
                        or f.ipcm[uy, ux]:
                    continue
                qps = tops.qp_scaled(int(f.qp[uy, ux]), True,
                                     sps.qp_bd_offset_y)
                if tsz == 4 and mode == MODE_INTRA:
                    add_dst(tx, ty, f.coeff_y, qps)
                else:
                    add(0, tx, ty, tsz, f.coeff_y, qps)
            for (cx, cy, csz, abs_part, ctu, trd) in f.chroma_tus[c0:c1]:
                ux, uy = cx // 2, cy // 2
                if f.tq_bypass[uy, ux] or f.ipcm[uy, ux]:
                    continue
                qp = int(f.qp[uy, ux])
                for comp, plane in ((1, f.coeff_cb), (2, f.coeff_cr)):
                    if not (int(f.cbf[comp, uy, ux]) >> trd) & 1:
                        continue
                    if f.ts_flag[comp, uy, ux]:
                        continue
                    qps = tops.qp_scaled(qp, False, sps.qp_bd_offset_c,
                                         qp_off[comp - 1])
                    add(comp, cx, cy, csz, plane, qps)
    return _launch_residuals(f, sps, groups)


def _pack_cgs(blocks: np.ndarray, size: int, n_padded: int):
    """CG-pack a dense TU batch for upload: only the coded (nonzero)
    4x4 coefficient groups ship, as (vals [M, 16] int16, idx [M] int32 =
    tu*ncg + cg_position).  M is padded to a power-of-two bucket; padded
    rows point at the device-side dummy slot n_padded * ncg."""
    n = len(blocks)
    ncg1 = size // 4
    g = blocks.reshape(n, ncg1, 4, ncg1, 4)
    ti, cy, cx = np.nonzero((g != 0).any(axis=(2, 4)))
    vals = np.ascontiguousarray(
        g.transpose(0, 1, 3, 2, 4)[ti, cy, cx]).reshape(-1, 16)
    idx = ((ti * ncg1 + cy) * ncg1 + cx).astype(np.int32)
    m = len(idx)
    cap = 256
    while cap < m:
        cap *= 2
    pv = np.zeros((cap, 16), np.int16)
    pv[:m] = vals
    pi = np.full(cap, n_padded * ncg1 * ncg1, np.int32)
    pi[:m] = idx
    return pv, pi


def _launch_residuals(f: FrameModel, sps: Sps, groups: dict) -> dict:
    """Run the gathered TU batches through dequant+IDCT — on device as
    async jx.residual_pipeline launches (one sync for the whole picture),
    else through the batched numpy kernels."""
    from ..ops import jx
    from ..ops.device import device_enabled
    bit_inc = sps.bit_increment
    use_device = device_enabled()

    store: dict = {}
    pending = []
    for (comp, size, use_dst), items in groups.items():
        blocks, qps, keys = _normalize_group(comp, size, items,
                                             np.int16 if use_device
                                             else np.int32)
        n = len(keys)
        # device path: pad to a power-of-FOUR bucket so per-frame count
        # jitter re-uses compiled shapes (every unique shape costs a full
        # XLA compile); ship coefficients as int16
        # (dequant clips to that range anyway) to halve the H2D bytes
        if use_device:
            cap = 64
            while cap < n:
                cap *= 4
            if cap != n:
                pad_q = np.zeros(cap, np.int32)
                pad_q[:n] = qps
                qps = pad_q
            # launch only — all size classes run asynchronously and are
            # synchronized once below (one host<->device round trip)
            from ..ops.device import stat_launch
            if size >= 8:
                # ship only coded CGs (fewer H2D bytes); 4x4 TUs stay
                # dense (1 CG each)
                vals, idx = _pack_cgs(blocks, size, cap)
                stat_launch(vals.nbytes + idx.nbytes + qps.nbytes)
                dev = jx.residual_pipeline_packed(vals, idx, qps, size,
                                                  use_dst, bit_inc)
            else:
                if cap != n:
                    pad_b = np.zeros((cap, size, size), blocks.dtype)
                    pad_b[:n] = blocks
                    blocks = pad_b
                stat_launch(blocks.nbytes + qps.nbytes)
                dev = jx.residual_pipeline(blocks, qps, use_dst, bit_inc)
            pending.append((dev, keys))
        else:
            # same batched formulation through the numpy kernels
            deq = tops.dequant(blocks, qps, bit_inc)
            resi = tops.inverse_transform(deq, use_dst, bit_inc)
            for i, k in enumerate(keys):
                store[k] = resi[i]
    for dev, _keys in pending:
        try:
            dev.copy_to_host_async()       # overlap all D2H transfers
        except AttributeError:
            pass
    for dev, keys in pending:
        resi = np.asarray(dev)
        from ..ops.device import stat_d2h
        stat_d2h(resi.nbytes)
        for i, k in enumerate(keys):
            store[k] = resi[i]
    return store


def _normalize_group(comp, size, items, dtype):
    """Accepts either array chunks (bx, by, blocks, qps) from the
    vectorized collector or per-TU (key, block, qp) tuples from the
    scalar fallback; returns (blocks [n,s,s] dtype, qps int32[n],
    keys [(comp,x,y)])."""
    if items and isinstance(items[0][0], np.ndarray):
        bxs = np.concatenate([c[0] for c in items])
        bys = np.concatenate([c[1] for c in items])
        blocks = np.concatenate([c[2] for c in items])
        if dtype == np.int16:
            blocks = np.clip(blocks, -32768, 32767)
        blocks = blocks.astype(dtype)
        qps = np.concatenate([c[3] for c in items]).astype(np.int32)
        keys = [(comp, int(x), int(y)) for x, y in zip(bxs, bys)]
        return blocks, qps, keys
    n = len(items)
    blocks = np.zeros((n, size, size), dtype)
    qps = np.zeros(n, np.int32)
    keys = []
    for i, (k, blk, q) in enumerate(items):
        blocks[i] = np.clip(blk, -32768, 32767) \
            if dtype == np.int16 else blk
        qps[i] = q
        keys.append(k)
    return blocks, qps, keys


class _FrameRecon:
    def __init__(self, f: FrameModel, sh: SliceHeader, sps: Sps, pps: Pps,
                 rec_y, rec_cb, rec_cr, inter_pred=None, store=None,
                 avail=None, scaling=None):
        self.f, self.sh, self.sps, self.pps = f, sh, sps, pps
        self.rec_y, self.rec_cb, self.rec_cr = rec_y, rec_cb, rec_cr
        self.inter_pred = inter_pred
        self.store = store          # batched residuals from device stage 1
        self.avail = avail          # vectorized availability context
        self.scaling = scaling      # active ActiveScaling tables or None
        self.bit_inc = sps.bit_increment
        self.max_val = (1 << sps.internal_bit_depth) - 1
        self.dc_val = 1 << (sps.internal_bit_depth - 1)

    def _flags(self, ux: int, uy: int, nu: int) -> np.ndarray:
        if self.avail is not None:
            return self.avail.tu_flags(ux, uy, nu)
        return _tu_availability_flags(self.f, ux, uy, nu)

    def _resi(self, comp: int, x: int, y: int, size: int, qps: int,
              use_dst: bool, ts: bool, bypass: bool, plane,
              is_intra: bool = True) -> np.ndarray:
        if self.scaling is not None and not bypass:
            blk = plane[y:y + size, x:x + size]
            deq_tab = self.scaling.tables_for(size, qps, is_intra, comp)[0]
            deq = scaling_mod.dequant_with_list(blk, deq_tab, qps,
                                                size.bit_length() - 1,
                                                self.bit_inc)
            if ts:
                return tops.transform_skip_inv(
                    deq[None], self.bit_inc)[0].astype(np.int32)
            return tops.inverse_transform(
                deq[None], use_dst, self.bit_inc)[0].astype(np.int32)
        if self.store is not None and not ts and not bypass:
            r = self.store.get((comp, x, y))
            if r is not None:
                return r
        return _residual(plane[y:y + size, x:x + size], qps, use_dst, ts,
                         bypass, self.bit_inc)

    # -- intra TU reconstruction (xIntraRecLumaBlk / xIntraRecChromaBlk) --
    def intra_luma_tu(self, tu) -> None:
        f, rec_y = self.f, self.rec_y
        (px, py, size, abs_part, ctu_addr, tr_depth) = tu
        ux, uy = px // 4, py // 4
        if f.ipcm[uy, ux]:
            rec_y[py:py + size, px:px + size] = \
                f.pcm_y[py:py + size, px:px + size]
            return
        mode = int(f.luma_dir[uy, ux])
        nu = size // 4
        flags = self._flags(ux, uy, nu)
        line = intra_ops.fill_reference_line(rec_y, px, py, size, 4, flags,
                                             self.dc_val)
        log2 = size.bit_length() - 1
        if intra_ops.use_filtered(mode, log2, True):
            line = intra_ops.smooth_reference_line(line, size, 4)
        pred = intra_ops.predict(line, size, 4, mode, True, self.max_val)
        cbf = (int(f.cbf[0, uy, ux]) >> tr_depth) & 1
        if cbf:
            qp = int(f.qp[uy, ux])
            qps = tops.qp_scaled(qp, True, self.sps.qp_bd_offset_y)
            resi = self._resi(0, px, py, size, qps, use_dst=(size == 4),
                              ts=bool(f.ts_flag[0, uy, ux]),
                              bypass=bool(f.tq_bypass[uy, ux]),
                              plane=f.coeff_y)
        else:
            resi = 0
        rec_y[py:py + size, px:px + size] = np.clip(
            pred + resi, 0, self.max_val).astype(rec_y.dtype)

    def intra_chroma_tu(self, tu) -> None:
        f, sh, pps = self.f, self.sh, self.pps
        (cx, cy, size, abs_part, ctu_addr, tr_depth) = tu
        ux, uy = cx // 2, cy // 2   # luma unit coords of the luma region
        if f.ipcm[uy, ux]:
            self.rec_cb[cy:cy + size, cx:cx + size] = \
                f.pcm_cb[cy:cy + size, cx:cx + size]
            self.rec_cr[cy:cy + size, cx:cx + size] = \
                f.pcm_cr[cy:cy + size, cx:cx + size]
            return
        # chroma pred mode: from CU part 0 (getChromaIntraDir(0))
        depth = int(f.depth[uy, ux])
        cu_units = f.units_per_row >> depth
        cux = (ux // cu_units) * cu_units
        cuy = (uy // cu_units) * cu_units
        mode = int(f.chroma_dir[cuy, cux])
        if mode == DM_CHROMA_IDX:
            mode = int(f.luma_dir[cuy, cux])
        nu = size // 2          # availability units (luma 4x4 parts)
        flags = self._flags(ux, uy, nu)
        cbf_u = (int(f.cbf[1, uy, ux]) >> tr_depth) & 1
        cbf_v = (int(f.cbf[2, uy, ux]) >> tr_depth) & 1
        qp = int(f.qp[uy, ux])
        for comp, rec_c, coeff_plane, cbf, qp_off in (
                (1, self.rec_cb, f.coeff_cb, cbf_u,
                 pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb),
                (2, self.rec_cr, f.coeff_cr, cbf_v,
                 pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr)):
            line = intra_ops.fill_reference_line(rec_c, cx, cy, size, 2,
                                                 flags, self.dc_val)
            pred = intra_ops.predict(line, size, 2, mode, False, self.max_val)
            if cbf:
                qps = tops.qp_scaled(qp, False, self.sps.qp_bd_offset_c, qp_off)
                resi = self._resi(comp, cx, cy, size, qps, use_dst=False,
                                  ts=bool(f.ts_flag[comp, uy, ux]),
                                  bypass=bool(f.tq_bypass[uy, ux]),
                                  plane=coeff_plane)
            else:
                resi = 0
            rec_c[cy:cy + size, cx:cx + size] = np.clip(
                pred + resi, 0, self.max_val).astype(rec_c.dtype)

    # -- inter CU reconstruction (xReconInter) -----------------------------
    def inter_cu(self, px, py, size, luma_tus, chroma_tus) -> None:
        f, sh, pps = self.f, self.sh, self.pps
        pred_y, pred_cb, pred_cr = self.inter_pred.predict_cu(px, py, size)
        resi_y = np.zeros_like(pred_y, np.int32)
        resi_cb = np.zeros_like(pred_cb, np.int32)
        resi_cr = np.zeros_like(pred_cr, np.int32)
        for (tx, ty, tsz, abs_part, ctu_addr, tr_depth) in luma_tus:
            ux, uy = tx // 4, ty // 4
            if (int(f.cbf[0, uy, ux]) >> tr_depth) & 1:
                qp = int(f.qp[uy, ux])
                qps = tops.qp_scaled(qp, True, self.sps.qp_bd_offset_y)
                resi_y[ty - py:ty - py + tsz, tx - px:tx - px + tsz] = \
                    self._resi(0, tx, ty, tsz, qps, use_dst=False,
                               ts=bool(f.ts_flag[0, uy, ux]),
                               bypass=bool(f.tq_bypass[uy, ux]),
                               plane=f.coeff_y, is_intra=False)
        cx0, cy0 = px // 2, py // 2
        for (cx, cy, csz, abs_part, ctu_addr, tr_depth) in chroma_tus:
            ux, uy = cx // 2, cy // 2
            qp = int(f.qp[uy, ux])
            for comp, resi_c, coeff_plane, qp_off in (
                    (1, resi_cb, f.coeff_cb,
                     pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb),
                    (2, resi_cr, f.coeff_cr,
                     pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr)):
                if (int(f.cbf[comp, uy, ux]) >> tr_depth) & 1:
                    qps = tops.qp_scaled(qp, False, self.sps.qp_bd_offset_c,
                                         qp_off)
                    resi_c[cy - cy0:cy - cy0 + csz, cx - cx0:cx - cx0 + csz] = \
                        self._resi(comp, cx, cy, csz, qps, use_dst=False,
                                   ts=bool(f.ts_flag[comp, uy, ux]),
                                   bypass=bool(f.tq_bypass[uy, ux]),
                                   plane=coeff_plane, is_intra=False)
        self.rec_y[py:py + size, px:px + size] = np.clip(
            pred_y.astype(np.int32) + resi_y, 0,
            self.max_val).astype(self.rec_y.dtype)
        cs = size // 2
        self.rec_cb[cy0:cy0 + cs, cx0:cx0 + cs] = np.clip(
            pred_cb.astype(np.int32) + resi_cb, 0,
            self.max_val).astype(self.rec_cb.dtype)
        self.rec_cr[cy0:cy0 + cs, cx0:cx0 + cs] = np.clip(
            pred_cr.astype(np.int32) + resi_cr, 0,
            self.max_val).astype(self.rec_cr.dtype)


def reconstruct_frame(f: FrameModel, sh: SliceHeader, sps: Sps, pps: Pps,
                      rec_y: np.ndarray, rec_cb: np.ndarray,
                      rec_cr: np.ndarray, inter_pred=None,
                      cu_range=None) -> None:
    """Walk CUs in decode order, reconstructing each (TDecCu::decodeCU).

    cu_range=(start, end) restricts to one slice's CUs so each slice is
    reconstructed with its own reference lists (multi-slice pictures)."""
    r = _FrameRecon(f, sh, sps, pps, rec_y, rec_cb, rec_cr, inter_pred)
    lo, hi = cu_range if cu_range is not None else (0, len(f.cu_list))
    for (px, py, size, mode, l0, l1, c0, c1) in f.cu_list[lo:hi]:
        if mode == MODE_INTRA:
            for tu in f.luma_tus[l0:l1]:
                r.intra_luma_tu(tu)
            for tu in f.chroma_tus[c0:c1]:
                r.intra_chroma_tu(tu)
        else:
            r.inter_cu(px, py, size, f.luma_tus[l0:l1], f.chroma_tus[c0:c1])


def _native_inter_prepass(f: FrameModel, sps: Sps, pps: Pps, runs, cu_arr,
                          lt_arr, ct_arr, rec_y, rec_cb, rec_cr, lib,
                          fill_frame_arrays) -> bool:
    """Reconstruct every inter CU natively (inter_recon_cus)."""
    import ctypes
    from .. import native
    inter_runs = [(sh, ip, lo, hi) for (sh, ip, lo, hi) in runs
                  if ip is not None
                  and (cu_arr[lo:hi, 3] != MODE_INTRA).any()]
    if not inter_runs:
        return True
    fa = fill_frame_arrays(f)
    # CU/TU decode-order lists: parse outputs for native-parsed frames,
    # rebuilt arrays for Python-parsed ones (inter slices)
    cu_c = np.ascontiguousarray(cu_arr, np.int32)
    lt_c = np.ascontiguousarray(lt_arr, np.int32)
    ct_c = np.ascontiguousarray(ct_arr, np.int32)
    fa.cu_list = cu_c.ctypes.data
    fa.luma_tus = lt_c.ctypes.data
    fa.chroma_tus = ct_c.ctypes.data
    bases = _native_bases()
    from ..common.rom import CHROMA_SCALE
    cscale = np.ascontiguousarray(CHROMA_SCALE, np.uint8)
    for (sh, ip, lo, hi) in inter_runs:
        refs = native.InterRefs()
        keep = []            # keep padded planes alive across the call
        margin = None
        for lst in (0, 1):
            pics = ip.lists[lst]
            refs.n_ref[lst] = len(pics)
            for i, pic in enumerate(pics):
                pad_y, pad_cb, pad_cr = pic.padded()
                keep.append((pad_y, pad_cb, pad_cr))
                refs.pad_y[lst * 16 + i] = pad_y.ctypes.data
                refs.pad_cb[lst * 16 + i] = pad_cb.ctypes.data
                refs.pad_cr[lst * 16 + i] = pad_cr.ctypes.data
                refs.ref_poc[lst * 16 + i] = pic.poc
                margin = pic.margin
                refs.ys = pad_y.shape[1]
                refs.cs = pad_cb.shape[1]
        refs.margin = margin
        # explicit weighted prediction tables (TComWeightPrediction.cpp)
        refs.wp_active = int(bool(ip.wp_active))
        if ip.wp_active and ip.wp is not None:
            refs.luma_log2_denom = ip.wp["luma_log2_denom"]
            refs.chroma_log2_denom = ip.wp["chroma_log2_denom"]
            for lst in (0, 1):
                for ri in range(len(ip.lists[lst])):
                    for comp in range(3):
                        w = ip.wp["wp"][lst][ri][comp]
                        idx = (lst * 16 + ri) * 3 + comp
                        refs.wp_w[idx] = int(w[1])
                        refs.wp_o[idx] = int(w[2])
        p = native.InterReconParams()
        p.slice_type = sh.slice_type
        p.wp_bipred = int(bool(pps.wp_bipred))
        p.bit_depth = sps.internal_bit_depth
        p.bit_inc = sps.bit_increment
        p.pic_w = sps.pic_width_in_luma_samples
        p.pic_h = sps.pic_height_in_luma_samples
        p.ctu_size = f.ctu_size
        p.rls = rec_y.shape[1]
        p.rcs = rec_cb.shape[1]
        p.ls = f.coeff_y.shape[1]
        p.cls = f.coeff_cb.shape[1]
        p.qp_bd_y = sps.qp_bd_offset_y
        p.qp_bd_c = sps.qp_bd_offset_c
        p.cb_off = pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb
        p.cr_off = pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr
        p.chroma_scale = cscale.ctypes.data
        p.dct4 = bases[4].ctypes.data
        p.dct8 = bases[8].ctypes.data
        p.dct16 = bases[16].ctypes.data
        p.dct32 = bases[32].ctypes.data
        lib.inter_recon_cus(ctypes.byref(fa), lo, hi, ctypes.byref(refs),
                            ctypes.byref(p),
                            rec_y.ctypes.data, rec_cb.ctypes.data,
                            rec_cr.ctypes.data)
        del keep
    return True


def _native_picture(f: FrameModel, sps: Sps, pps: Pps, runs,
                    rec_y, rec_cb, rec_cr) -> bool:
    """Whole-picture reconstruction through the native core: inter CUs
    first (per-PU MC + per-TU residual add, inter_recon_cus — they read
    only reference pictures, so reconstructing them ahead of the in-order
    intra walk is bit-equivalent), then the intra TUs in decode order
    (intra_recon_tus).  Returns False (no-op) when unavailable.

    When the device path is active, all-intra pictures run the HYBRID:
    stage-1 residuals are computed on the device (jx.residual_pipeline) and
    the native walk consumes them through IntraParams.resi_buf/resi_map;
    inter pictures keep the Python device path (batched device MC), so
    the native fast path stands down for them."""
    import os
    from ..ops.device import device_enabled
    if os.environ.get("THEVC_NATIVE", "1") == "0":
        return False
    device = device_enabled()
    from .. import native
    lib = native.get_lib()
    if lib is None:
        return False
    import ctypes
    from .native_parse import fill_frame_arrays

    nat = getattr(f, "_native_out", None)
    if nat is not None:
        cu_arr = nat["cu_list"]
        lt_arr, ct_arr = nat["luma_tus"], nat["chroma_tus"]
    else:
        cu_arr = (np.asarray(f.cu_list, np.int32).reshape(-1, 8)
                  if f.cu_list else np.zeros((0, 8), np.int32))
        lt_arr = (np.asarray(f.luma_tus, np.int32).reshape(-1, 6)
                  if f.luma_tus else np.zeros((0, 6), np.int32))
        ct_arr = (np.asarray(f.chroma_tus, np.int32).reshape(-1, 6)
                  if f.chroma_tus else np.zeros((0, 6), np.int32))
    for (sh, inter_pred, lo, hi) in runs:
        if (cu_arr[lo:hi, 3] != MODE_INTRA).any():
            if device:
                # inter pictures use the Python device path (batched
                # device MC + device residuals)
                return False
            if inter_pred is None:
                return False
            if any(len(lst) > 16 for lst in inter_pred.lists):
                return False

    resi_store = None
    if device:
        # the multi-picture decode pipeline pre-attaches a store computed
        # by ONE batched launch per TU size class across many pictures
        # (batched_residual_stores); per-picture launches are the fallback
        resi_store = getattr(f, "_resi_store", None)
        if resi_store is None:
            resi_store = _device_residual_store(f, sps, pps, runs)
        if resi_store is None:
            return False

    if not device and not _native_inter_prepass(
            f, sps, pps, runs, cu_arr, lt_arr, ct_arr,
            rec_y, rec_cb, rec_cr, lib, fill_frame_arrays):
        return False

    avail = _AvailCtx(f)
    maps = native.AvailMaps(
        avail.order.ctypes.data, avail.in_pic.ctypes.data,
        avail.ctu.ctypes.data, avail.tile.ctypes.data,
        np.ascontiguousarray(f.slice_start).ctypes.data,
        avail._PAD, avail.order.shape[1], f.slice_start.shape[1])
    # keep the sstart array alive for the duration of the calls
    sstart = np.ascontiguousarray(f.slice_start)
    maps.sstart = sstart.ctypes.data

    bases = _native_bases()

    # per-TU recon rows built natively (build_intra_rows); per-run chroma
    # QP offsets come from the slice header
    from ..common.rom import CHROMA_SCALE
    cscale = np.ascontiguousarray(CHROMA_SCALE, np.uint8)
    fa = fill_frame_arrays(f)
    n_lt, n_ct = len(lt_arr), len(ct_arr)
    rows_y = np.empty((max(n_lt, 1), 10), np.int32)
    rows_cb = np.empty((max(n_ct, 1), 10), np.int32)
    rows_cr = np.empty((max(n_ct, 1), 10), np.int32)
    n_y = np.zeros(1, np.int32)
    n_cb = np.zeros(1, np.int32)
    n_cr = np.zeros(1, np.int32)
    for (sh, inter_pred, lo, hi) in runs:
        lib.build_intra_rows(
            ctypes.byref(fa), cu_arr.ctypes.data, lo, hi,
            lt_arr.ctypes.data, ct_arr.ctypes.data,
            sps.qp_bd_offset_y, sps.qp_bd_offset_c,
            pps.chroma_cb_qp_offset + sh.slice_qp_delta_cb,
            pps.chroma_cr_qp_offset + sh.slice_qp_delta_cr,
            cscale.ctypes.data,
            rows_y.ctypes.data, n_y.ctypes.data,
            rows_cb.ctypes.data, n_cb.ctypes.data,
            rows_cr.ctypes.data, n_cr.ctypes.data)

    bit_inc = sps.bit_increment
    max_val = (1 << sps.internal_bit_depth) - 1
    dc_val = 1 << (sps.internal_bit_depth - 1)
    plane_cfg = (
        (rows_y, int(n_y[0]), rec_y, f.coeff_y, 4, 4, 1,
         getattr(f, "pcm_y", None), 0),
        (rows_cb, int(n_cb[0]), rec_cb, f.coeff_cb, 2, 2, 0,
         getattr(f, "pcm_cb", None), 1),
        (rows_cr, int(n_cr[0]), rec_cr, f.coeff_cr, 2, 2, 0,
         getattr(f, "pcm_cr", None), 2),
    )
    for tu_arr, n_rows, rec, coeff, unit, adiv, is_luma, pcm, comp \
            in plane_cfg:
        if not n_rows:
            continue
        params = native.IntraParams(
            rec.shape[1], coeff.shape[1], unit, adiv, is_luma, dc_val,
            max_val, bit_inc,
            bases[4].ctypes.data, bases[8].ctypes.data,
            bases[16].ctypes.data, bases[32].ctypes.data,
            bases["dst"].ctypes.data,
            pcm.ctypes.data if pcm is not None else None,
            pcm.shape[1] if pcm is not None else 0)
        if resi_store is not None:
            buf, comp_maps = resi_store
            params.resi_buf = buf.ctypes.data
            params.resi_map = comp_maps[comp].ctypes.data
            params.map_w = comp_maps[comp].shape[1]
        lib.intra_recon_tus(
            rec.ctypes.data, coeff.ctypes.data,
            tu_arr.ctypes.data, n_rows,
            ctypes.byref(maps), ctypes.byref(params))
    return True


def _device_residual_store(f: FrameModel, sps: Sps, pps: Pps, runs):
    """Stage-1 residuals on the device for the native-walk hybrid: returns
    (resi_buf int32, per-comp offset maps [uh, uw]) or None.  The maps
    are keyed by the TU's top-left luma 4x4 unit (chroma samples / 2)."""
    from ..ops import jx
    groups: dict = {}
    if not _collect_residuals_vec(f, sps, pps, runs, groups):
        return None
    bit_inc = sps.bit_increment
    uh, uw = f.depth.shape
    comp_maps = [np.full((uh, uw), -1, np.int32) for _ in range(3)]
    launches = []
    total = 0
    for (comp, size, use_dst), chunks in groups.items():
        bxs = np.concatenate([c[0] for c in chunks])
        bys = np.concatenate([c[1] for c in chunks])
        blocks = np.clip(np.concatenate([c[2] for c in chunks]),
                         -32768, 32767).astype(np.int16)
        qps = np.concatenate([c[3] for c in chunks]).astype(np.int32)
        n = len(bxs)
        cap = 64
        while cap < n:
            cap *= 4
        if cap != n:
            pad_b = np.zeros((cap, size, size), np.int16)
            pad_b[:n] = blocks
            pad_q = np.zeros(cap, np.int32)
            pad_q[:n] = qps
            blocks, qps = pad_b, pad_q
        from ..ops.device import stat_launch
        stat_launch(blocks.nbytes + qps.nbytes)
        dev = jx.residual_pipeline(blocks, qps, use_dst, bit_inc)
        launches.append((comp, size, dev, n, bxs, bys))
        total += n * size * size
    for _comp, _size, dev, _n, _bxs, _bys in launches:
        try:
            dev.copy_to_host_async()       # overlap all D2H transfers
        except AttributeError:
            pass
    buf = np.empty(max(total, 1), np.int32)
    off = 0
    for comp, size, dev, n, bxs, bys in launches:
        sz = size * size
        resi = np.asarray(dev)[:n]
        from ..ops.device import stat_d2h
        stat_d2h(resi.nbytes)
        buf[off:off + n * sz] = resi.reshape(-1)
        div = 4 if comp == 0 else 2
        comp_maps[comp][bys // div, bxs // div] = \
            off + np.arange(n, dtype=np.int64) * sz
        off += n * sz
    return buf, comp_maps


def batched_residual_stores(items) -> None:
    """Stage-1 residuals for MANY pictures in ONE launch per TU size
    class (multi-frame launch batching: all-intra pictures are mutually
    independent, so their TU batches concatenate — the launch and
    transfer latency is paid once per stream batch, not once per frame).

    items: [(f, sps, pps, runs)].  Attaches f._resi_store = (buf int32,
    per-comp offset maps) to every picture whose TUs vector-collect; the
    rest fall back to the per-picture path (_device_residual_store).
    Mirrors TDecGop::decompressSlice's per-picture residual pass — the
    batching is pure schedule, the math is byte-identical."""
    from ..ops import jx
    from ..ops.device import stat_d2h, stat_launch

    per_pic = []        # (f, groups) for batchable pictures
    bit_inc = None
    for f, sps, pps, runs in items:
        g: dict = {}
        if _collect_residuals_vec(f, sps, pps, runs, g):
            if bit_inc is None:
                bit_inc = sps.bit_increment
            if sps.bit_increment == bit_inc:
                per_pic.append((f, g))
    if not per_pic:
        return

    merged: dict = {}   # class -> [(pic_i, bxs, bys, blocks, qps)]
    for pi, (f, g) in enumerate(per_pic):
        for key, chunks in g.items():
            bxs = np.concatenate([c[0] for c in chunks])
            bys = np.concatenate([c[1] for c in chunks])
            blocks = np.concatenate([c[2] for c in chunks])
            qps = np.concatenate([c[3] for c in chunks]).astype(np.int32)
            merged.setdefault(key, []).append((pi, bxs, bys, blocks, qps))

    launches = []
    for (comp, size, use_dst), lst in merged.items():
        blocks = np.clip(np.concatenate([e[3] for e in lst]),
                         -32768, 32767).astype(np.int16)
        qps = np.concatenate([e[4] for e in lst])
        n = len(blocks)
        cap = 64
        while cap < n:
            cap *= 4
        if cap != n:
            pad_q = np.zeros(cap, np.int32)
            pad_q[:n] = qps
            qps = pad_q
        if size >= 8:
            # CG-packed upload: only coded 4x4 groups are shipped
            vals, idx = _pack_cgs(blocks, size, cap)
            stat_launch(vals.nbytes + idx.nbytes + qps.nbytes)
            dev = jx.residual_pipeline_packed(vals, idx, qps, size,
                                              use_dst, bit_inc)
        else:
            if cap != n:
                pad_b = np.zeros((cap, size, size), np.int16)
                pad_b[:n] = blocks
                blocks = pad_b
            stat_launch(blocks.nbytes + qps.nbytes)
            dev = jx.residual_pipeline(blocks, qps, use_dst, bit_inc)
        launches.append((comp, size, dev, lst, n))
    for _comp, _size, dev, _lst, _n in launches:
        try:
            dev.copy_to_host_async()       # overlap all D2H transfers
        except AttributeError:
            pass

    pic_parts: list = [[] for _ in per_pic]
    for comp, size, dev, lst, n in launches:
        resi = np.asarray(dev)[:n]
        stat_d2h(resi.nbytes)
        off = 0
        for (pi, bxs, bys, _blocks, _qps) in lst:
            k = len(bxs)
            pic_parts[pi].append((comp, size, resi[off:off + k], bxs, bys))
            off += k

    for pi, (f, _g) in enumerate(per_pic):
        uh, uw = f.depth.shape
        comp_maps = [np.full((uh, uw), -1, np.int32) for _ in range(3)]
        total = sum(r.size for _c, _s, r, _bx, _by in pic_parts[pi])
        buf = np.empty(max(total, 1), np.int32)
        off = 0
        for comp, size, resi, bxs, bys in pic_parts[pi]:
            sz = size * size
            k = len(bxs)
            buf[off:off + k * sz] = resi.reshape(-1)
            div = 4 if comp == 0 else 2
            comp_maps[comp][bys // div, bxs // div] = \
                off + np.arange(k, dtype=np.int64) * sz
            off += k * sz
        f._resi_store = (buf, comp_maps)


_BASES = None


def _native_bases():
    global _BASES
    if _BASES is None:
        from ..common.rom import DCT_MATRICES, DST4
        _BASES = {s: np.ascontiguousarray(DCT_MATRICES[s], np.int32)
                  for s in (4, 8, 16, 32)}
        _BASES["dst"] = np.ascontiguousarray(DST4, np.int32)
    return _BASES


def reconstruct_picture(f: FrameModel, sps: Sps, pps: Pps, runs,
                        rec_y: np.ndarray, rec_cb: np.ndarray,
                        rec_cr: np.ndarray, scaling=None) -> None:
    """Whole-picture reconstruction: stage 1 batches every coded TU's
    dequant+IDCT on device, stage 2 walks CUs in decode order doing
    prediction + add with the precomputed residuals (SURVEY.md section 7).

    runs: [(sh, inter_pred, cu_lo, cu_hi)] — one entry per slice segment.
    scaling: active ActiveScaling tables (routes every TU through the
    per-coefficient dequant; batching/native paths are bypassed).
    """
    if scaling is None and _native_picture(f, sps, pps, runs, rec_y,
                                           rec_cb, rec_cr):
        return
    store = _collect_residuals(f, sps, pps, runs) if scaling is None else None
    from ..ops.device import device_enabled
    if device_enabled():
        # stage 2 of the device decode path: the whole picture's MC runs
        # as grouped device launches before the CU walk (MC reads only
        # reference pictures, so every PU is independent)
        for (sh, inter_pred, lo, hi) in runs:
            if inter_pred is not None:
                inter_pred.precompute_device(f.cu_list[lo:hi])
    avail = _AvailCtx(f)
    for (sh, inter_pred, lo, hi) in runs:
        r = _FrameRecon(f, sh, sps, pps, rec_y, rec_cb, rec_cr, inter_pred,
                        store=store, avail=avail, scaling=scaling)
        for (px, py, size, mode, l0, l1, c0, c1) in f.cu_list[lo:hi]:
            if mode == MODE_INTRA:
                for tu in f.luma_tus[l0:l1]:
                    r.intra_luma_tu(tu)
                for tu in f.chroma_tus[c0:c1]:
                    r.intra_chroma_tu(tu)
            else:
                r.inter_cu(px, py, size, f.luma_tus[l0:l1],
                           f.chroma_tus[c0:c1])


def reconstruct_intra_frame(f: FrameModel, sh: SliceHeader, sps: Sps,
                            pps: Pps, rec_y: np.ndarray, rec_cb: np.ndarray,
                            rec_cr: np.ndarray) -> None:
    reconstruct_frame(f, sh, sps, pps, rec_y, rec_cb, rec_cr)
