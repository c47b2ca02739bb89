"""The command: without a card it fails and prints no result; on the card
(``cuda``) a short run of a cell prints a correct result line."""

import json
import os
import subprocess
import sys

import pytest
import torch

from voxbench import manifest


def _command(*args, env=None):
    return subprocess.run([sys.executable, "-m", "voxbench", *args], cwd=manifest.ROOT, capture_output=True,
                          text=True, env=env, timeout=1200)


def test_without_a_card_the_command_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command("--workload", "app1k_720p.query", "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0",
                   env=env)
    assert out.returncode != 0 and out.stdout == "", (out.returncode, out.stdout, out.stderr[-2000:])
    assert "CUDA" in out.stderr


def test_an_unknown_cell_is_refused():
    out = _command("--workload", "no_such_cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    out = _command("--workload", "app1k_720p.query", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["correct"] and rec["device"]["platform"] == "gpu" and list(rec)[-1] == "check"
