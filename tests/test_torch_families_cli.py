"""The port's serve and train CLIs for one arch of each new family kind (MoE,
SSM, vision, audio) at ``--smoke --device cpu``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
ARCHS = ("granite-moe-1b-a400m", "rwkv6-7b", "llama-3.2-vision-11b",
         "whisper-small")


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_family_on_cpu(arch):
    out = _run("repro_torch.launch.serve", "--arch", arch, "--smoke",
               "--device", "cpu", "--batch", "2", "--prompt-len", "8",
               "--gen", "4")
    assert f"{arch}-smoke" in out and "prefill 2x8" in out
    assert "decode 4 tokens" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_each_family_on_cpu(arch):
    out = _run("repro_torch.launch.train", "--arch", arch, "--smoke",
               "--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
               "32")
    assert "2 steps" in out and "loss" in out
    assert "nan" not in out.lower()
