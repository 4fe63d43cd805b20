"""chip_smoke.py's contract where there is no card: it refuses to run, prints
no result, and its last line (on a card) has the fixed shape."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_refuses_cpu(capsys, argv):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_without_the_repo(tmp_path):
    """Alone in a directory, the script exits non-zero with no ok line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_ok_line_format():
    devices = jax.devices()[:4]
    line = chip_smoke.ok_line(devices)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}


@pytest.mark.parametrize("n_flipped,ok", [(1, True), (2, False)])
def test_flip_bar(n_flipped, ok):
    """At most 0.1% of pixels may move by more than one uint8 level."""
    a = np.full((40, 25, 3), 0.5, np.float32)          # 1000 pixels
    b = a.copy()
    b[:n_flipped, 0, 1] += 3.0 / 255.0                 # one channel, 3 levels
    b[10:, :, :] += 1.0 / 255.0                         # within one level
    if ok:
        chip_smoke.check_flips("case", a, b)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_flips("case", a, b)


def test_four_card_phase_on_virtual_devices():
    """Rehearsal of the four-card phase on 4 virtual CPU devices (Pallas
    interpreter, tiny image)."""
    chip_smoke.phase_four_cards(jax.devices()[:4], width=32, height=16,
                                n_spheres=12, loss_size=(32, 16),
                                interpret=True)
