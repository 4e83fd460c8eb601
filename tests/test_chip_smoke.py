"""chip_smoke.py on the CPU: which phases a command line selects, the
format of the result line, and that a run without a GPU fails before it
prints any result."""

import json
import os
import subprocess
import sys

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_selection():
    assert chip_smoke.select_phases([]) == (
        "cli", "kernels", "oracle", "inverse", "terrain")
    assert chip_smoke.select_phases(["--four-cards"]) == ("four_cards",)
    for name in chip_smoke.PHASES + chip_smoke.FOUR_CARD_PHASES:
        assert callable(getattr(chip_smoke, f"phase_{name}"))


def test_last_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.last_line([Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4},
    }


def test_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "JAX found no GPU" in r.stderr
