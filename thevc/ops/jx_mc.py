"""JAX motion-compensation interpolation, batched over equal-size PUs.

Behavioral reference: TComInterpolationFilter.cpp (filter<> :164,
filterCopy :85, coefficient tables :55/:63); bit-exact mirror of
ops.interp._filter_copy/_filter_1d including the reference's int16
(Short) intermediate wrap-around semantics.

Batching model: every PU of a picture is independent of the current
picture's reconstruction (MC reads reference pictures only), so the
decoder gathers all PU reference windows of one (width, height,
filter-case) class and runs them as a single launch of these kernels —
two tap-contractions plus elementwise shifts per class.
The fractional phase varies per PU: the tap vector is gathered per PU
(coeff[frac]), which keeps mixed-phase batches in one launch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .interp import (CHROMA_FILTER, IF_FILTER_PREC, IF_INTERNAL_OFFS,
                     IF_INTERNAL_PREC, LUMA_FILTER)

# kept as NUMPY at module scope: a module-level jnp.asarray would become
# a leaked tracer constant if this module is first imported inside a
# traced function (jit caches the import-time array)
_LUMA = np.asarray(LUMA_FILTER, np.int32)
_CHROMA = np.asarray(CHROMA_FILTER, np.int32)


def _copy_batch(src, bd, is_last):
    """filterCopy (first pass): [N, h, w] int16 pixels -> int16."""
    if is_last:
        return src.astype(jnp.int16)
    shift = IF_INTERNAL_PREC - bd
    return ((src.astype(jnp.int32) << shift)
            - IF_INTERNAL_OFFS).astype(jnp.int16)


def _filter_1d_batch(src, coeff, vertical, bd, is_first, is_last,
                     out_h, out_w):
    """filter<N>: src [N, H, W] int16, coeff [N, taps] int32 per PU."""
    n_taps = coeff.shape[1]
    head_room = IF_INTERNAL_PREC - bd
    shift = IF_FILTER_PREC
    if is_last:
        shift += 0 if is_first else head_room
        offset = 1 << (shift - 1)
        offset += 0 if is_first else IF_INTERNAL_OFFS << IF_FILTER_PREC
    else:
        shift -= head_room if is_first else 0
        offset = (-IF_INTERNAL_OFFS << shift) if is_first else 0

    s = src.astype(jnp.int32)
    # the tap contraction as multiply + tree-sum in int32
    if vertical:
        win = jnp.stack([s[:, k:k + out_h, :out_w] for k in range(n_taps)],
                        axis=1)
    else:
        win = jnp.stack([s[:, :out_h, k:k + out_w] for k in range(n_taps)],
                        axis=1)
    acc = (win * coeff[:, :, None, None]).sum(axis=1)
    val = (acc + offset) >> shift
    if is_last:
        val = jnp.clip(val, 0, (1 << bd) - 1)
    return val.astype(jnp.int16)


@partial(jax.jit, static_argnames=("case", "luma", "bd", "bi",
                                   "out_h", "out_w"))
def mc_batch(windows: jnp.ndarray, frac_x: jnp.ndarray, frac_y: jnp.ndarray,
             case: str, luma: bool, bd: int, bi: bool,
             out_h: int, out_w: int) -> jnp.ndarray:
    """One MC class: windows [N, wh, ww] int16 (already positioned so that
    element (0,0) is the first tap sample), per-PU fractional phases.

    case: "copy" | "hor" | "ver" | "2d" (the four _mc_block paths —
    kept distinct because the reference's single-pass rounding for the
    hor/ver-only cases differs from a synthetic two-pass).
    Returns [N, out_h, out_w] int16 — pixel domain when not bi, else the
    14-bit internal domain.
    """
    filt = jnp.asarray(_LUMA if luma else _CHROMA, jnp.int32)
    n_taps = 8 if luma else 4
    is_last = not bi
    if case == "copy":
        return _copy_batch(windows[:, :out_h, :out_w], bd, is_last)
    if case == "hor":
        return _filter_1d_batch(windows, filt[frac_x], False, bd, True,
                                is_last, out_h, out_w)
    if case == "ver":
        return _filter_1d_batch(windows, filt[frac_y], True, bd, True,
                                is_last, out_h, out_w)
    tmp = _filter_1d_batch(windows, filt[frac_x], False, bd, True, False,
                           out_h + n_taps - 1, out_w)
    return _filter_1d_batch(tmp, filt[frac_y], True, bd, False, is_last,
                            out_h, out_w)


@partial(jax.jit, static_argnames=("bd",))
def bi_avg_batch(p0: jnp.ndarray, p1: jnp.ndarray, bd: int) -> jnp.ndarray:
    """TComYuv::addAvg over a PU batch."""
    shift = IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    val = (p0.astype(jnp.int32) + p1.astype(jnp.int32) + offset) >> shift
    return jnp.clip(val, 0, (1 << bd) - 1).astype(jnp.int16)
