"""Import hygiene: the port, chip_smoke.py, chip_kernel_times.py and
chip_parallel.py import no JAX, no flax and nothing of the JAX package
(tests/torch_parallel_workers.py neither: spawned processes load it)."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import setok_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax") or m.startswith(("jax.", "flax."))
             or m == "setok_tpu" or m.startswith("setok_tpu."))
print(json.dumps(bad))
"""


def test_port_and_chip_smoke_import_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        setok_tpu_torch.__path__, prefix="setok_tpu_torch."))
    assert "setok_tpu_torch.kernels.cluster_dpc" in modules
    # the stage-1 training path
    assert {"setok_tpu_torch.train.stage1", "setok_tpu_torch.losses.gan",
            "setok_tpu_torch.losses.lpips",
            "setok_tpu_torch.losses.contrastive",
            "setok_tpu_torch.losses.mse",
            "setok_tpu_torch.models.text_encoder",
            "setok_tpu_torch.utils.metrics",
            "setok_tpu_torch.utils.synthetic",
            "setok_tpu_torch.scripts.train_setok"} <= set(modules)
    # the serving features
    assert {"setok_tpu_torch.serve.speculative",
            "setok_tpu_torch.serve.calibrate"} <= set(modules)
    # checkpoints, the model builder and the evaluation entry points
    assert {"setok_tpu_torch.models.builder",
            "setok_tpu_torch.utils.checkpoint",
            "setok_tpu_torch.utils.porting",
            "setok_tpu_torch.scripts.eval_recon",
            "setok_tpu_torch.scripts.eval_vqa",
            "setok_tpu_torch.data.image_processing",
            "setok_tpu_torch.data.native",
            "setok_tpu_torch.data.vqa_eval"} <= set(modules)
    # the data pipeline
    assert {f"setok_tpu_torch.data.{m}" for m in (
        "conversation", "mm_tokens", "preprocess", "collator", "datasets",
        "sampler", "loader", "anyres")} | {
        "setok_tpu_torch.utils.logging"} <= set(modules)
    # the parallel item
    assert {f"setok_tpu_torch.parallel.{m}" for m in (
        "mesh", "sharding", "ring_attention", "comm")} <= set(modules)
    # the remaining scripts and utils
    assert {"setok_tpu_torch.utils.tokens",
            "setok_tpu_torch.utils.compile_cache",
            "setok_tpu_torch.scripts.port_weights",
            "setok_tpu_torch.scripts.assemble_pretrained",
            "setok_tpu_torch.scripts.extract_components"} <= set(modules)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, "setok_tpu_torch", *modules,
         "chip_smoke", "chip_kernel_times", "chip_parallel",
         "tests.torch_parallel_workers"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
