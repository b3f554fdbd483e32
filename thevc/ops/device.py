"""Device-path policy: when the codec's batched math runs on the GPU.

THEVC_DEVICE=1 forces the JAX device path on, =0 forces it off; unset
means AUTO — on exactly when JAX's default backend is a GPU, off on
CPU-only hosts where the native AVX2 core wins.  Tests exercise the
device code path on a CPU-JAX mesh by setting THEVC_DEVICE=1 under
JAX_PLATFORMS=cpu (tests/conftest.py), so the gate runs on every CI
invocation without a GPU.
"""

from __future__ import annotations

import os
from collections import Counter
from pathlib import Path

_cache: dict = {}

# where the persistent compile cache goes when JAX_COMPILATION_CACHE_DIR
# is unset: a fixed path inside the checkout (gitignored via .cache/)
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".cache" / "jax"

# transfer/launch accounting for the device path (reported per frame so
# the host<->device traffic is auditable), and the devices the launches
# ran on (so a run can prove where its work landed)
STATS = {"launches": 0, "h2d_bytes": 0, "d2h_bytes": 0}
LAUNCH_DEVICES: Counter = Counter()


def stat_launch(h2d_bytes: int = 0, device=None) -> None:
    STATS["launches"] += 1
    STATS["h2d_bytes"] += int(h2d_bytes)
    LAUNCH_DEVICES[device if device is not None else current_device()] += 1


def stat_d2h(nbytes: int) -> None:
    STATS["d2h_bytes"] += int(nbytes)


def stats_reset() -> dict:
    """Return the counters so far and zero them (and the device tally)."""
    out = dict(STATS)
    for k in STATS:
        STATS[k] = 0
    LAUNCH_DEVICES.clear()
    return out


def device_enabled() -> bool:
    env = os.environ.get("THEVC_DEVICE", "")
    if env == "1":
        enable_compile_cache()
        return True
    if env == "0":
        return False
    if "auto" not in _cache:
        import jax
        _cache["auto"] = jax.default_backend() == "gpu"
    if _cache["auto"]:
        enable_compile_cache()
    return _cache["auto"]


def compile_cache_dir() -> str | None:
    """The persistent compile cache in force: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else the in-repo path once
    enable_compile_cache() has run on an accelerator."""
    import jax
    return jax.config.jax_compilation_cache_dir or None


def enable_compile_cache() -> None:
    """Persistent XLA compilation cache: a cold encode or decode compiles
    a dozen shape classes, so cache them across processes."""
    if "cc" in _cache:
        return
    _cache["cc"] = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if current_device().platform == "cpu":
        # XLA:CPU AOT cache entries carry prefer-no-gather/no-scatter
        # machine features; reloaded executables run ~10x slower than a
        # fresh compile (measured on the decision pass: 0.8 -> 7.8
        # s/frame @1080p).  Persist only for accelerators.
        return
    import jax
    REPO_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def current_device():
    """The device jitted codec work is placed on: jax_default_device when
    set (a `with jax.default_device(d)` block sets it per thread), else
    the default backend's first device."""
    import jax
    d = jax.config.jax_default_device
    if d is None:
        return jax.devices()[0]
    if isinstance(d, str):
        return jax.devices(d)[0]
    return d


def on_current_device(fn):
    """Wrap fn for a worker thread: the device in force in the calling
    thread (`jax.default_device` is per thread) stays in force in fn."""
    import jax
    dev = jax.config.jax_default_device
    if dev is None:
        return fn

    def run(*args, **kwargs):
        with jax.default_device(dev):
            return fn(*args, **kwargs)
    return run


def reset_cache() -> None:
    _cache.clear()
