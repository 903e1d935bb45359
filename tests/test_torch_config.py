"""quflow_tpu_torch.config.device: the default is the CUDA device, and
without one it raises; the CPU is used only when asked for."""

import numpy as np
import pytest
import torch

from quflow_tpu_torch import config, physics


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.device(None)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.device() == torch.device("cuda")
    assert config.device(None).type == "cuda"


@pytest.mark.parametrize("dev", ["cpu", torch.device("cpu")])
def test_cpu_only_when_asked(monkeypatch, dev):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.device(dev) == torch.device("cpu")


def test_energy_logger_takes_the_device(monkeypatch):
    """energy_euler solves where it is told, and refuses the unasked CPU."""
    rng = np.random.RandomState(0)
    W = rng.randn(8, 8) + 1j * rng.randn(8, 8)
    W = W - W.conj().T
    W -= np.eye(8) * np.trace(W) / 8
    e = physics.energy_euler(W, device="cpu")
    assert e.shape == () and np.isfinite(e) and e > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        physics.energy_euler(W)
