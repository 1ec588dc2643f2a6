"""The CLIs under `torchrun` on the CPU (two gloo processes, the tiny
configuration): `train_setokim --tensor-parallel 2` trains and the first
rank alone prints its steps; `serve --tensor-parallel 2` serves, with the
same completions as one process."""

import json
import os
import subprocess
import sys
from pathlib import Path

from tests import torch_parallel_workers as W

ROOT = Path(__file__).resolve().parents[1]


def torchrun(*args, nproc=2, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_train_setokim_tensor_parallel_under_torchrun():
    out = torchrun("-m", "setok_tpu_torch.scripts.train_setokim", "--cpu",
                   "--tiny", "--synthetic", "--steps", "1", "--batch-size",
                   "2", "--model-max-length", "48", "--lora-enable",
                   "--lora-r", "4", "--tensor-parallel", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert [(x["step"], x["updates"]) for x in lines] == [(0, 1)]


def test_serve_tensor_parallel_under_torchrun(capsys):
    from setok_tpu_torch.scripts import serve
    argv = ["--cpu", "--tiny", "--bits", "8", "--kv-bits", "8",
            "--max-new-tokens", "2", "--prompt-len", "16", "--max-len", "24"]
    out = torchrun("-m", "setok_tpu_torch.scripts.serve", *argv,
                   "--tensor-parallel", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    W.one_thread(serve.main)(argv)
    one = capsys.readouterr().out

    def completions(text):
        return [x for x in text.splitlines() if x.startswith("[")]

    assert len(completions(out.stdout)) == 4
    assert completions(out.stdout) == completions(one)
    assert "4 requests, 8 tokens" in out.stdout
