"""chip_smoke.py rehearsed on the CPU at a small size.

The script itself refuses to run without a GPU; here its phases run with
JAX on the CPU (THEVC_DEVICE=1 drives the device code paths), so a wrong
path, argument or check fails before a run on the card."""

import os
import subprocess
import sys

import pytest

from tests.conftest import REPO


@pytest.fixture
def smoke(monkeypatch):
    import chip_smoke
    from thevc.ops import device
    monkeypatch.setattr(chip_smoke, "PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "W", 64)
    monkeypatch.setattr(chip_smoke, "H", 48)
    monkeypatch.setenv("THEVC_DEVICE", "1")
    device.reset_cache()
    yield chip_smoke
    device.reset_cache()


def test_chip_smoke_refuses_cpu(tmp_path):
    """No GPU: a non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_parity_small(smoke):
    smoke.phase_parity()


@pytest.mark.parametrize("name,cfg,frames", [
    ("allintra", "encoder_intra_main.cfg", 2),
    ("randomaccess", "encoder_randomaccess_main.cfg", 3),
])
def test_chip_smoke_encode_decode_small(smoke, tmp_path, name, cfg, frames):
    bits = smoke.encode_decode(tmp_path, name, cfg, frames, 1)
    assert bits.stat().st_size > 0


def test_chip_smoke_devapply_small(smoke, tmp_path):
    smoke.phase_devapply(tmp_path)
