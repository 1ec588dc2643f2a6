"""The port's component scripts against the JAX package's on the CPU:
`extract_components` (a stage-1 run's tokenizer and detokenizer as the
Setokim's `vision_tower` / `vision_generator` files) and
`assemble_pretrained` (HF-layout state dicts spliced into a Setokim's six
component files).

Both sides start from the same weights: the JAX stage-1 checkpoint is
written by `setok_tpu.utils.checkpoint.save_checkpoint` from the port
SeTok's `to_flax_tree`, and the JAX assembly's `load_pretrained_model` is
handed the port's seed-0 tiny Setokim through `to_flax_tree` (no flax
init, no JAX trainer). Bars: every file key for key, every array bit for
bit; the spliced tensors equal their sources (chip_smoke.spliced_sources,
the layout change written apart from the porters), max abs 0.
"""

import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from setok_tpu import config as jcfg
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.builder import load_pretrained_model
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.scripts import (assemble_pretrained, extract_components,
                                     train_setok)
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.from_flax import to_flax_tree
from test_torch_port_weights import BERT, LLAMA, SIGLIP, jax_script
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STAGE1 = ["--tiny", "--image-size", "32"]


def same_npz(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files) and a.files
    for key in a.files:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


@pytest.fixture(scope="module")
def stage1_run(tmp_path_factory):
    """A port stage-1 run directory: one update of the CLI, checkpointed."""
    out = tmp_path_factory.mktemp("stage1")
    train_setok.main(["--cpu", *STAGE1, "--synthetic", "4", "--steps", "1",
                      "--batch-size", "2", "--output-dir", str(out)])
    return out


def test_extract_components_matches_jax(stage1_run, tmp_path, capsys):
    extract_components.main([str(stage1_run), str(tmp_path / "port"),
                             *STAGE1])
    assert "wrote" in capsys.readouterr().out

    # the same SeTok as a JAX stage-1 checkpoint (the Stage1State's
    # gen_params['setok'] tree)
    from setok_tpu.utils.checkpoint import save_checkpoint
    tok, det = train_setok.configs(train_setok.parse_args(
        ["--synthetic", "1", *STAGE1]))
    setok = SeTok(tok, det, device="meta")
    setok.load_state_dict(extract_components.setok_params(str(stage1_run)),
                          assign=True)
    jdir = tmp_path / "jax_run"
    save_checkpoint(str(jdir / "checkpoints"), 1,
                    {"gen_params": {"setok": to_flax_tree(setok)}})
    jax_script("extract_components").extract(str(jdir),
                                             str(tmp_path / "jax"))
    for root in ("vision_tower", "vision_generator"):
        same_npz(tmp_path / "port" / f"{root}.npz",
                 tmp_path / "jax" / f"{root}.npz")


def test_extract_components_warns_for_a_missing_half(tmp_path, capsys):
    """A checkpoint without the detokenizer gives the tower's file and the
    JAX script's warning; a configuration that is not the run's raises."""
    tok, det = tcfg.tiny_tokenizer(), tcfg.tiny_detokenizer()
    model = SeTok(tok, det, device="cpu")
    params = {f"setok.{k}": v for k, v in model.state_dict().items()
              if k.startswith("tokenizer.")}
    ckpt.save_checkpoint(str(tmp_path / "run" / "checkpoints"), 3,
                         {"params": params})
    written = extract_components.main([str(tmp_path / "run"),
                                       str(tmp_path / "out"), *STAGE1])
    assert written == {"vision_tower": len(params)}
    assert "warning: no vision_generator weights found" in \
        capsys.readouterr().out
    with pytest.raises(RuntimeError, match="size mismatch"):
        extract_components.main([str(tmp_path / "run"),
                                 str(tmp_path / "out2"), "--tiny",
                                 "--image-size", "64"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        extract_components.main([str(tmp_path), str(tmp_path / "out3")])


@pytest.fixture(scope="module")
def hf_files(tmp_path_factory):
    """HF-layout state dicts at tiny_setokim()'s geometries: SigLIP as
    .safetensors, LLaMA fp16 .bin, BERT .bin (6 layers; the mapper takes
    2)."""
    root = tmp_path_factory.mktemp("assemble")
    gen = torch.Generator().manual_seed(11)
    sds = {"siglip": cs.hf_siglip_state(gen, **SIGLIP),
           "llama": cs.hf_llama_state(gen, **LLAMA),
           "bert": cs.hf_bert_state(gen, **BERT)}
    paths = {"siglip": root / "siglip.safetensors",
             "llama": root / "llama.bin", "bert": root / "bert.bin"}
    cs.write_safetensors(paths["siglip"], sds["siglip"])
    torch.save(sds["llama"], paths["llama"])
    # a SiglipVisionTransformer's own dict: no `vision_model.` prefix
    torch.save({k[len("vision_model."):]: v for k, v in sds["siglip"].items()},
               root / "siglip_bare.bin")
    torch.save(sds["bert"], paths["bert"])
    return {k: str(v) for k, v in paths.items()}, sds, root


def test_assemble_matches_jax_cli(hf_files, tmp_path, capsys,
                                  monkeypatch):
    paths, sds, _ = hf_files
    flags = ["--siglip", paths["siglip"], "--llama", paths["llama"],
             "--bert", paths["bert"], "--tiny"]
    report = assemble_pretrained.main([str(tmp_path / "port"), *flags,
                                       "--cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert all(u == 0 for _, u in report.values())

    # the JAX CLI from the port's seed-0 weights
    seed0 = to_flax_tree(load_pretrained_model("", tiny=True, device="cpu"))
    import setok_tpu.models.builder as jbuilder
    monkeypatch.setattr(jbuilder, "load_pretrained_model", lambda *a, **k: (
        types.SimpleNamespace(cfg=jcfg.tiny_setokim()), seed0))
    monkeypatch.setitem(sys.modules, "port_weights",
                        jax_script("port_weights"))
    jax_script("assemble_pretrained").main([str(tmp_path / "jax"), *flags])
    theirs = capsys.readouterr().out.splitlines()
    assert mine[:-1] == theirs[:-1]          # the spliced n/m reports
    for comp in assemble_pretrained.COMPONENTS:
        same_npz(tmp_path / "port" / f"{comp}.npz",
                 tmp_path / "jax" / f"{comp}.npz")


def test_assembled_tensors_equal_their_sources(hf_files, tmp_path):
    """Every spliced tensor equals its HF source with the layout change
    applied; a bare SigLIP dict (no `vision_model.` prefix) takes the same
    path; the six files load back through the builder."""
    paths, sds, root = hf_files
    cfg = tcfg.tiny_setokim()
    model, report = assemble_pretrained.assemble(
        str(root / "siglip_bare.bin"), paths["llama"], paths["bert"],
        tiny=True, device="cpu")
    sources = cs.spliced_sources(sds["siglip"], sds["llama"], sds["bert"],
                                 cfg.detokenizer.mapper_layers)
    assert report == {
        assemble_pretrained.SIGLIP_ROOT: (3 + 12 * SIGLIP["layers"], 0),
        assemble_pretrained.LLAMA_ROOT: (3 + 9 * LLAMA["layers"], 0),
        assemble_pretrained.BERT_ROOT: (2 + 16 * 2, 0)}
    gap = cs.spliced_gap(model, sources)
    assert gap["entries"] == len(sources) and gap["max_abs"] == 0.0, gap
    assemble_pretrained.write_components(model, str(tmp_path))
    back = load_pretrained_model(
        "", tiny=True, device="cpu", projector_path=[
            str(tmp_path / f"{c}.npz")
            for c in assemble_pretrained.COMPONENTS])
    assert cs.spliced_gap(back, sources)["max_abs"] == 0.0
    for key, value in model.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
