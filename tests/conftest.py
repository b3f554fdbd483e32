"""Test configuration.

Tests run JAX on the CPU with 8 virtual devices, so the multi-device
logic (jax.sharding.Mesh over a stream axis) is exercised without a GPU.
Device code paths run here under THEVC_DEVICE=1.  Tests that need the
GPU take the `gpu` fixture (and carry the `gpu` marker): they skip here
and run on the card through `python chip_smoke.py`.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402

from thevc.utils.cfg import CFG_DIR  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE_BIN = REPO / ".oracle" / "bin"
TESTDATA = REPO / "testdata"


def have_oracle() -> bool:
    return (ORACLE_BIN / "TAppEncoder").exists()


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at
    import or collection time (xdist workers must collect alike)."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU; runs on the card via chip_smoke.py")
    return devs[0]


@pytest.fixture(scope="session")
def oracle():
    """Paths to the HM reference binaries (built by tools/build_oracle.sh)."""
    if not have_oracle():
        pytest.skip("HM oracle not built (run tools/build_oracle.sh)")
    return ORACLE_BIN


@pytest.fixture(scope="session")
def test_clip():
    """Deterministic synthetic 416x240 clip, 8 frames."""
    TESTDATA.mkdir(exist_ok=True)
    clip = TESTDATA / "clip_416x240.yuv"
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "416", "--height", "240", "--frames", "8"],
            check=True)
    return clip


def ensure_clip(name: str, width: int, height: int, frames: int):
    """Create (if missing) a deterministic synthetic clip in testdata/.

    Shared clips like clip_96x80_9f.yuv are used across test modules;
    every user must call this so tests stay order-independent."""
    TESTDATA.mkdir(exist_ok=True)
    clip = TESTDATA / name
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", str(width), "--height", str(height),
             "--frames", str(frames)],
            check=True)
    return clip


def oracle_encode(cfg: str, clip, out_bin, out_rec, frames=2, extra=()):
    """Run the HM oracle encoder with the given base cfg."""
    cmd = [str(ORACLE_BIN / "TAppEncoder"),
           "-c", f"{CFG_DIR}/{cfg}",
           "-i", str(clip), "-wdt", "416", "-hgt", "240",
           "-f", str(frames), "-fr", "30",
           "-b", str(out_bin), "-o", str(out_rec),
           "--SEIpictureDigest=1", *extra]
    subprocess.run(cmd, check=True, capture_output=True)


@pytest.fixture(scope="session")
def golden_intra_stream(oracle, test_clip):
    """HM-encoded all-intra Main stream + reconstruction (2 frames, QP32)."""
    out_bin = TESTDATA / "intra_main_q32.bin"
    out_rec = TESTDATA / "intra_main_q32_rec.yuv"
    if not out_bin.exists() or not out_rec.exists():
        oracle_encode("encoder_intra_main.cfg", test_clip, out_bin, out_rec)
    return {"bin": out_bin, "rec": out_rec, "width": 416, "height": 240,
            "frames": 2}


@pytest.fixture(scope="session")
def test_clip_small(oracle):
    """Deterministic synthetic 176x144 clip, 9 frames (inter configs)."""
    TESTDATA.mkdir(exist_ok=True)
    clip = TESTDATA / "clip_176x144_9f.yuv"
    if not clip.exists():
        subprocess.run(
            ["python", str(REPO / "tools" / "make_test_clip.py"), str(clip),
             "--width", "176", "--height", "144", "--frames", "9"],
            check=True)
    return clip


def oracle_encode_small(cfg: str, clip, out_bin, frames=9, extra=()):
    cmd = [str(ORACLE_BIN / "TAppEncoder"),
           "-c", f"{CFG_DIR}/{cfg}",
           "-i", str(clip), "-wdt", "176", "-hgt", "144",
           "-f", str(frames), "-fr", "30",
           "-b", str(out_bin), "-o", "/dev/null",
           "--SEIpictureDigest=1", *extra]
    subprocess.run(cmd, check=True, capture_output=True)
