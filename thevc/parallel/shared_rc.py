"""Mesh-wide rate control: a shared bit pool across parallel encoders.

SURVEY.md section 2e names exactly one collective the multi-stream encode
plan needs: frame-level rate feedback.  Each mesh slot encodes its own
stream (data-parallel over a 1-D `stream` mesh axis); after every frame
the per-slot bit counts are psum'd over the mesh (one scalar per slot —
the collective rides NVLink between GPUs) and every slot re-derives its
next-frame budget from the GLOBAL remaining pool.  A slot that undershot
gets more room only because the mesh-wide sum says the pool allows it —
the rate-control state is a function of the collective's result.

The QP update is the frame-level half of the reference's URQ model
(TEncRateCtrl::getFrameQP, TEncRateCtrl.cpp:321): budget-ratio driven QP
deltas clamped to +-2 per frame and +-4 overall, without the MAD model
(open-loop multi-stream encoders have no shared texture statistics).
"""

from __future__ import annotations

import numpy as np


class MeshRatePool:
    """Shared bit pool over a 1-D device mesh with axis name `stream`.

    Usage per frame k:
        targets = pool.frame_targets(spent_bits_per_slot)
        qps     = pool.frame_qps(base_qps, spent_bits_per_slot)
    `spent` is the per-slot total bits written so far; both calls run one
    jitted psum over the mesh and return per-slot host values.
    """

    def __init__(self, mesh, total_bits: int, n_frames: int):
        self.mesh = mesh
        self.total_bits = int(total_bits)
        self.n_frames = int(n_frames)
        self.n = mesh.devices.size
        self._built = None

    def _fn(self):
        if self._built is not None:
            return self._built
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = self.mesh
        spec = P("stream")

        def body(spent):
            # spent: this slot's bits so far [1]
            global_spent = jax.lax.psum(jnp.sum(spent), "stream")
            return jnp.broadcast_to(global_spent[None], spent.shape)

        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                               out_specs=spec))
        sharding = NamedSharding(mesh, spec)
        self._built = (fn, sharding)
        return self._built

    def global_spent(self, spent: np.ndarray) -> int:
        """psum the per-slot spent bits; returns the mesh-wide total."""
        import jax
        fn, sharding = self._fn()
        dev = jax.device_put(np.asarray(spent, np.int32), sharding)
        out = np.asarray(jax.block_until_ready(fn(dev)))
        return int(out[0])

    def frame_targets(self, spent: np.ndarray, frames_done: int
                      ) -> np.ndarray:
        """Per-slot bit target for the next frame from the GLOBAL pool:
        remaining pool split evenly over remaining slot-frames."""
        g = self.global_spent(spent)
        remaining_frames = self.n * (self.n_frames - frames_done)
        if remaining_frames <= 0:
            return np.zeros(self.n)
        per = max(0.0, (self.total_bits - g) / remaining_frames)
        return np.full(self.n, per)

    def frame_qps(self, base_qps: np.ndarray, spent: np.ndarray,
                  frames_done: int) -> np.ndarray:
        """QP for each slot's next frame: base QP nudged by the ratio of
        its last-frame spend to the pool-derived target (getFrameQP's
        budget-ratio clamp, TEncRateCtrl.cpp:321-420)."""
        targets = self.frame_targets(spent, frames_done)
        per_frame_spent = np.asarray(spent, np.float64) / max(1, frames_done)
        qps = np.asarray(base_qps, np.int32).copy()
        for i in range(self.n):
            if targets[i] <= 0:
                continue
            ratio = per_frame_spent[i] / targets[i]
            if ratio > 1.25:
                qps[i] += 2
            elif ratio > 1.05:
                qps[i] += 1
            elif ratio < 0.8:
                qps[i] -= 2
            elif ratio < 0.95:
                qps[i] -= 1
        return np.clip(qps, 0, 51)
