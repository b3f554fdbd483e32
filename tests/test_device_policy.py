"""Device-path policy (ops/device.py) and the native build's key
(native/__init__.py): AUTO, placement, the compile cache's location."""

import threading

import pytest


@pytest.fixture
def device(monkeypatch):
    from thevc.ops import device as mod
    monkeypatch.delenv("THEVC_DEVICE", raising=False)
    mod.reset_cache()
    yield mod
    mod.reset_cache()


def test_device_auto_is_gpu_only(device, monkeypatch):
    """AUTO is decided in process from the default backend: off on CPU;
    THEVC_DEVICE=1/0 force it either way."""
    assert device.device_enabled() is False
    monkeypatch.setenv("THEVC_DEVICE", "1")
    assert device.device_enabled() is True
    monkeypatch.setenv("THEVC_DEVICE", "0")
    assert device.device_enabled() is False


def test_current_device_follows_default_device(device):
    """`with jax.default_device(d)` places codec work on d, also inside
    worker threads wrapped with on_current_device."""
    import jax
    cpus = jax.devices("cpu")
    assert device.current_device() == jax.devices()[0]
    seen = []
    with jax.default_device(cpus[3]):
        assert device.current_device() == cpus[3]
        job = device.on_current_device(
            lambda: seen.append(device.current_device()))
    t = threading.Thread(target=job)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and seen == [cpus[3]]


def test_launch_devices_counted(device):
    import jax
    cpus = jax.devices("cpu")
    device.stats_reset()
    device.stat_launch(10, device=cpus[2])
    with jax.default_device(cpus[1]):
        device.stat_launch(5)
    assert device.STATS["launches"] == 2 and device.STATS["h2d_bytes"] == 15
    assert dict(device.LAUNCH_DEVICES) == {cpus[2]: 1, cpus[1]: 1}
    device.stats_reset()
    assert not device.LAUNCH_DEVICES


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_location(device, monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the code sets no directory (JAX
    uses the variable); without it an accelerator run caches at the fixed
    in-repo path.  CPU runs keep no persistent cache."""
    import jax

    class _Gpu:
        platform = "gpu"

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(device, "REPO_CACHE_DIR", tmp_path / "jax")
    monkeypatch.setattr(device, "current_device", lambda: _Gpu())
    device.enable_compile_cache()
    if env_dir:
        assert updates == {}
    else:
        assert updates["jax_compilation_cache_dir"] == str(tmp_path / "jax")
        assert (tmp_path / "jax").is_dir()


def test_compile_cache_off_on_cpu(device, monkeypatch):
    import jax
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    device.enable_compile_cache()
    assert updates == {}


def test_native_library_keyed_to_host(monkeypatch):
    """The native library's name changes with the host CPU and the flags,
    and it lives in the gitignored build directory."""
    from thevc import native
    from tests.conftest import REPO
    here = native.lib_path()
    assert here.parent == REPO / "build" / "native"
    monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
    other = native.lib_path()
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["-DX"])
    assert len({here, other, native.lib_path()}) == 3
