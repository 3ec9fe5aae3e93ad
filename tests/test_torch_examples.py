"""The port's entry points that train the dense transformer, end to end on
the CPU at tiny sizes: ``repro_torch.examples.quickstart`` (the paper's
two-line API on reduced phi3), ``repro_torch.examples.train_lm`` (the
phi3-family training driver: checkpoints, ``--resume``, the replan loop)
and ``launch/train.py`` with its default arch (phi3, ``--reduced``)."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.examples import quickstart, train_lm
from repro_torch.launch import train as launch_train


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager ops: one intra-op thread beside the other test
    workers, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_loss_drops(capsys):
    losses = quickstart.main(device="cpu")
    assert len(losses) == 20 and all(np.isfinite(losses))
    # the reference's own expectation: ~0.5 below step 0 by the end
    assert np.mean(losses[-5:]) < losses[0] - 0.3, losses
    out = capsys.readouterr().out
    assert "comm plan:" in out and "embed via dense" in out


def test_train_lm_checkpoints_resumes_and_replans(tmp_path, capsys):
    # 256 Zipf(1.3) tokens a step over a vocab of 8,192: the observed
    # unique count sits well below the uniform estimate the buffer starts
    # at, so the replan after step 2 shrinks it
    argv = ["--steps", "4", "--seq", "64", "--batch", "4", "--ckpt-dir",
            str(tmp_path), "--replan-every", "2"]
    first = train_lm.main(argv, device="cpu")
    assert first["step"] == 4 and len(first["losses"]) == 4
    assert all(np.isfinite(first["losses"]))
    assert first["replans"] >= 1
    assert latest_step(str(tmp_path)) == 4
    assert "model: " in capsys.readouterr().out
    again = train_lm.main(["--steps", "6", "--seq", "64", "--batch", "4",
                           "--ckpt-dir", str(tmp_path), "--resume"],
                          device="cpu")
    assert again["step"] == 6 and len(again["losses"]) == 2
    assert "resumed at step 4" in capsys.readouterr().out


def test_launcher_trains_its_default_arch():
    out = launch_train.main(["--reduced", "--seq", "16", "--batch", "4",
                             "--steps", "3", "--log-every", "1"],
                            device="cpu")
    assert out["trainer"].model_cfg.name == "phi3-medium-14b"
    assert out["step"] == 3 and all(np.isfinite(out["losses"]))
    assert out["trainer"].rt.run_cfg.remat == "block"
