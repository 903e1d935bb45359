"""chip_smoke.py, the port's check on a CUDA card, rehearsed on the CPU:
without a card it refuses to run and prints no result; its phases run at
small sizes through the plain solve, so that an API change breaks here
and not first on the card."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from quflow_tpu_torch.ops import cuda_solve, tridiag  # noqa: E402

torch.set_num_threads(1)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "cuda.is_available() is false" in res.stderr


@pytest.fixture
def cpu_rehearsal(monkeypatch):
    """The smoke's phases on the CPU: no CUDA events or synchronize, and
    the plain solve counted as if it were the kernel's launches."""

    def counted(w, binv, u, d):
        cuda_solve.shear_thomas.launches += 1
        return cuda_solve.shear_thomas_reference(w, binv, u, d)

    monkeypatch.setattr(tridiag, "shear_thomas", counted)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_phases_rehearse_on_cpu(cpu_rehearsal):
    rows = chip_smoke.kernel_vs_plain("cpu", Ns=(16,), Bs=(1, 2))
    assert len(rows) == 4 and all(r["max_abs_err"] == 0.0 for r in rows)
    c64 = chip_smoke.main_path_c64("cpu", N=32, steps=10, steps_out=5,
                                   compare_steps=2)
    assert c64["launches"] == c64["expected_launches"] == 10 * 5 + 3
    assert c64["kernel_vs_plain_10_steps"] == 0.0
    c128 = chip_smoke.main_path_c128("cpu", N=32, steps=20)
    assert c128["tr_W2_drift"] <= 1e-10 and c128["tr_W3_drift"] <= 1e-10
