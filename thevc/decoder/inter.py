"""Inter prediction driver: per-PU motion compensation over the DPB.

Behavioral reference: TComPrediction.cpp (motionCompensation :551,
xPredInterUni :445, xPredInterBi :485, xCheckIdenticalMotion :411,
xWeightedAverage :900), TComDataCU::clipMv (TComDataCU.cpp:2684).

Host-side this runs per PU via ops.interp's vectorized separable filters;
the device path batches equal-size PU gathers + two tap-matmuls per plane
(ops.jx mirror) since every PU of a frame is independent.
"""

from __future__ import annotations

import numpy as np

from ..ops.interp import bi_avg, mc_chroma, mc_luma
from .mv import clip_mv, num_pus, pu_geometry


class InterPredictor:
    """Motion compensation for one slice: holds ref lists + geometry."""

    def __init__(self, frame, sh, sps, pps, list0, list1):
        self.f = frame
        self.sh = sh
        self.sps = sps
        self.pps = pps
        self.lists = [list0, list1]
        self.bd = sps.internal_bit_depth
        self.pic_w = sps.pic_width_in_luma_samples
        self.pic_h = sps.pic_height_in_luma_samples
        self.ctu = sps.max_cu_width
        # explicit weighted prediction (TComWeightPrediction.cpp)
        self.wp_active = (pps.use_wp and sh.slice_type == 1) or \
                         (pps.wp_bipred and sh.slice_type == 0)
        self.wp = getattr(sh, "wp_scaling", None) if self.wp_active else None

    # -- weighted prediction helpers (TComWeightPrediction.cpp:61-366) ----
    def _wp_params(self, lst: int, ref: int, comp: int):
        """(weight, iOffset, log2denom) for one list/ref/component."""
        w = self.wp["wp"][lst][ref][comp]
        denom = self.wp["luma_log2_denom"] if comp == 0 \
            else self.wp["chroma_log2_denom"]
        return w[1], w[2], denom

    def _weight_uni(self, blk, lst, ref, comp):
        """addWeightUni: src is in the 14-bit internal domain (bi=True)."""
        w, ioff, denom = self._wp_params(lst, ref, comp)
        bd = self.bd
        offset = ioff * (1 << (bd - 8))
        shift = denom + (14 - bd)
        round_ = (1 << (shift - 1)) if shift else 0
        v = ((w * (blk.astype(np.int64) + 8192) + round_) >> shift) + offset
        return np.clip(v, 0, (1 << bd) - 1).astype(np.int16)

    def _weight_bi(self, b0, b1, ref0, ref1, comp):
        """addWeightBi with the bi-dir derivation (getWpScaling)."""
        w0, io0, denom = self._wp_params(0, ref0, comp)
        w1, io1, _ = self._wp_params(1, ref1, comp)
        bd = self.bd
        o0 = io0 * (1 << (bd - 8))
        o1 = io1 * (1 << (bd - 8))
        offset = o0 + o1
        shift = denom + 1 + (14 - bd)
        round_ = (1 << (shift - 1)) if shift else 0
        v = (w0 * (b0.astype(np.int64) + 8192)
             + w1 * (b1.astype(np.int64) + 8192)
             + round_ + (offset << (shift - 1))) >> shift
        return np.clip(v, 0, (1 << bd) - 1).astype(np.int16)

    def predict_cu(self, px: int, py: int, size: int):
        """motionCompensation over all PUs of the CU at (px, py).

        Returns (pred_y, pred_cb, pred_cr) int16 blocks in pixel domain.
        """
        f = self.f
        pred_y = np.zeros((size, size), np.int16)
        cs = size // 2
        pred_cb = np.zeros((cs, cs), np.int16)
        pred_cr = np.zeros((cs, cs), np.int16)
        part_sz = int(f.part_size_arr[py // 4, px // 4])
        for pu in range(num_pus(part_sz)):
            xp, yp, pw, ph = pu_geometry(part_sz, px, py, size, pu)
            dev = self._dev_store.get((xp, yp)) \
                if self._dev_store is not None else None
            if dev is not None:
                blk_y, blk_cb, blk_cr = dev
                lx, ly = xp - px, yp - py
                pred_y[ly:ly + ph, lx:lx + pw] = blk_y
                pred_cb[ly // 2:(ly + ph) // 2,
                        lx // 2:(lx + pw) // 2] = blk_cb
                pred_cr[ly // 2:(ly + ph) // 2,
                        lx // 2:(lx + pw) // 2] = blk_cr
                continue
            self._predict_pu(px, py, xp, yp, pw, ph,
                             pred_y, pred_cb, pred_cr, px, py)
        return pred_y, pred_cb, pred_cr

    # -- device batch path ------------------------------------------------
    _dev_store = None

    def _enumerate_pus(self, cu_entries):
        """(xp, yp, pw, ph, cu_x, cu_y, ref0, mv0, ref1, mv1) per PU of
        the given inter CUs (mirrors predict_cu + xCheckIdenticalMotion)."""
        f = self.f
        pus = []
        for (px, py, size, mode, l0, l1, c0, c1) in cu_entries:
            part_sz = int(f.part_size_arr[py // 4, px // 4])
            for pu in range(num_pus(part_sz)):
                xp, yp, pw, ph = pu_geometry(part_sz, px, py, size, pu)
                ref0, mv0 = self._pu_motion(xp, yp, 0)
                ref1, mv1 = self._pu_motion(xp, yp, 1)
                if (self.sh.slice_type == 0 and not self.pps.wp_bipred and
                        ref0 >= 0 and ref1 >= 0 and
                        self.lists[0][ref0].poc == self.lists[1][ref1].poc
                        and mv0 == mv1):
                    ref1 = -1
                pus.append((xp, yp, pw, ph, px, py, ref0, mv0, ref1, mv1))
        return pus

    def precompute_device(self, cu_entries) -> None:
        """Batch the whole picture's MC as grouped device launches
        (ops.jx_mc): one launch per (component, filter-case, size) class,
        plus one bi-average launch per size.  Weighted prediction falls
        back to the host path (wp streams keep self._dev_store None)."""
        if self.wp_active:
            return
        from ..ops import jx_mc
        from .frame import MODE_INTRA
        entries = [e for e in cu_entries if e[3] != MODE_INTRA]
        pus = self._enumerate_pus(entries)
        if not pus:
            return

        # one uni-directional MC job per (PU, active list)
        jobs = []        # (key, window, fx, fy, out_idx)
        results: dict = {}
        for i, (xp, yp, pw, ph, cux, cuy, ref0, mv0, ref1, mv1) in \
                enumerate(pus):
            bi = ref0 >= 0 and ref1 >= 0
            for lst, ref, mv in ((0, ref0, mv0), (1, ref1, mv1)):
                if ref < 0:
                    continue
                pic = self.lists[lst][ref]
                mvc = clip_mv(mv, cux, cuy, self.pic_w, self.pic_h,
                              self.ctu)
                pad_y, pad_cb, pad_cr = pic.padded()
                m = pic.margin
                for comp, plane, mrg, d, shift_bits in (
                        (0, pad_y, m, 1, 2), (1, pad_cb, m // 2, 2, 3),
                        (2, pad_cr, m // 2, 2, 3)):
                    taps = 8 if comp == 0 else 4
                    half = taps // 2
                    x0 = mrg + xp // d + (mvc[0] >> shift_bits)
                    y0 = mrg + yp // d + (mvc[1] >> shift_bits)
                    fx = mvc[0] & ((1 << shift_bits) - 1)
                    fy = mvc[1] & ((1 << shift_bits) - 1)
                    w, h = pw // d, ph // d
                    if fx == 0 and fy == 0:
                        case = "copy"
                        win = plane[y0:y0 + h, x0:x0 + w]
                    elif fy == 0:
                        case = "hor"
                        win = plane[y0:y0 + h,
                                    x0 - (half - 1):x0 + w + half]
                    elif fx == 0:
                        case = "ver"
                        win = plane[y0 - (half - 1):y0 + h + half,
                                    x0:x0 + w]
                    else:
                        case = "2d"
                        win = plane[y0 - (half - 1):y0 + h + half,
                                    x0 - (half - 1):x0 + w + half]
                    jobs.append(((comp == 0, case, h, w, bi),
                                 win, fx, fy, (i, lst, comp)))

        # group into batches and launch
        groups: dict = {}
        for key, win, fx, fy, out in jobs:
            groups.setdefault(key, []).append((win, fx, fy, out))
        for (luma, case, h, w, bi), items in groups.items():
            wins = np.stack([it[0] for it in items]).astype(np.int16)
            fxs = np.asarray([it[1] for it in items], np.int32)
            fys = np.asarray([it[2] for it in items], np.int32)
            from ..ops.device import stat_d2h, stat_launch
            stat_launch(wins.nbytes + fxs.nbytes + fys.nbytes)
            out = np.asarray(jx_mc.mc_batch(wins, fxs, fys, case=case,
                                            luma=luma, bd=self.bd, bi=bi,
                                            out_h=h, out_w=w))
            stat_d2h(out.nbytes)
            for blk, (_w, _fx, _fy, okey) in zip(out, items):
                results[okey] = blk

        # combine lists per PU (bi average batched per size class)
        bi_jobs: dict = {}
        store = {}
        for i, (xp, yp, pw, ph, _cux, _cuy, ref0, _m0, ref1, _m1) in \
                enumerate(pus):
            if ref0 >= 0 and ref1 >= 0:
                for comp in range(3):
                    d = 1 if comp == 0 else 2
                    bi_jobs.setdefault((ph // d, pw // d), []).append(
                        (results[(i, 0, comp)], results[(i, 1, comp)],
                         (i, comp)))
            else:
                lst = 0 if ref0 >= 0 else 1
                store[(xp, yp)] = tuple(results[(i, lst, comp)]
                                        for comp in range(3))
        if bi_jobs:
            combined: dict = {}
            for (h, w), items in bi_jobs.items():
                p0 = np.stack([a for a, _b, _k in items])
                p1 = np.stack([b for _a, b, _k in items])
                avg = np.asarray(jx_mc.bi_avg_batch(p0, p1, self.bd))
                for blk, (_a, _b, k) in zip(avg, items):
                    combined[k] = blk
            for i, (xp, yp, *_rest) in enumerate(pus):
                if (i, 0) in combined:
                    store[(xp, yp)] = tuple(combined[(i, comp)]
                                            for comp in range(3))
        self._dev_store = store

    # ------------------------------------------------------------------
    def _pu_motion(self, xp, yp, lst):
        f = self.f
        ux, uy = xp // 4, yp // 4
        ref = int(f.ref_idx[lst, uy, ux])
        mv = (int(f.mv[lst, uy, ux, 0]), int(f.mv[lst, uy, ux, 1]))
        return ref, mv

    def _predict_pu(self, cu_x, cu_y, xp, yp, pw, ph,
                    pred_y, pred_cb, pred_cr, px0, py0):
        ref0, mv0 = self._pu_motion(xp, yp, 0)
        ref1, mv1 = self._pu_motion(xp, yp, 1)
        lx, ly = xp - px0, yp - py0

        # xCheckIdenticalMotion: B slice, no weighted bipred, both lists on
        # the same picture with the same MV -> uni L0
        if (self.sh.slice_type == 0 and not self.pps.wp_bipred and
                ref0 >= 0 and ref1 >= 0 and
                self.lists[0][ref0].poc == self.lists[1][ref1].poc and
                mv0 == mv1):
            ref1 = -1

        if ref0 >= 0 and ref1 >= 0:
            y0, cb0, cr0 = self._mc_one(0, ref0, mv0, cu_x, cu_y,
                                        xp, yp, pw, ph, bi=True)
            y1, cb1, cr1 = self._mc_one(1, ref1, mv1, cu_x, cu_y,
                                        xp, yp, pw, ph, bi=True)
            if self.wp_active:
                blk_y = self._weight_bi(y0, y1, ref0, ref1, 0)
                blk_cb = self._weight_bi(cb0, cb1, ref0, ref1, 1)
                blk_cr = self._weight_bi(cr0, cr1, ref0, ref1, 2)
            else:
                blk_y = bi_avg(y0, y1, self.bd)
                blk_cb = bi_avg(cb0, cb1, self.bd)
                blk_cr = bi_avg(cr0, cr1, self.bd)
        else:
            lst = 0 if ref0 >= 0 else 1
            ref = ref0 if ref0 >= 0 else ref1
            mv = mv0 if ref0 >= 0 else mv1
            blk_y, blk_cb, blk_cr = self._mc_one(
                lst, ref, mv, cu_x, cu_y, xp, yp, pw, ph,
                bi=self.wp_active)
            if self.wp_active:
                blk_y = self._weight_uni(blk_y, lst, ref, 0)
                blk_cb = self._weight_uni(blk_cb, lst, ref, 1)
                blk_cr = self._weight_uni(blk_cr, lst, ref, 2)
        pred_y[ly:ly + ph, lx:lx + pw] = blk_y
        pred_cb[ly // 2:(ly + ph) // 2, lx // 2:(lx + pw) // 2] = blk_cb
        pred_cr[ly // 2:(ly + ph) // 2, lx // 2:(lx + pw) // 2] = blk_cr

    def _mc_one(self, lst, ref_idx, mv, cu_x, cu_y, xp, yp, pw, ph, bi):
        pic = self.lists[lst][ref_idx]
        mv = clip_mv(mv, cu_x, cu_y, self.pic_w, self.pic_h, self.ctu)
        pad_y, pad_cb, pad_cr = pic.padded()
        m = pic.margin
        y = mc_luma(pad_y, m, xp, yp, mv[0], mv[1], pw, ph, self.bd, bi)
        cb = mc_chroma(pad_cb, m // 2, xp // 2, yp // 2, mv[0], mv[1],
                       pw // 2, ph // 2, self.bd, bi)
        cr = mc_chroma(pad_cr, m // 2, xp // 2, yp // 2, mv[0], mv[1],
                       pw // 2, ph // 2, self.bd, bi)
        return y, cb, cr
