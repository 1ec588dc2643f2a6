"""`models/builder.load_pretrained_model` of the port against the JAX
package's, on the same files.

A whole tiny Setokim tree written by the JAX package's `save_subtree` (the
`projector_path` file: every leaf, so that no leaf is left to either
package's initialiser) and a JAX LoRA `.npz` ({'<kernel path>/a', '/b'},
the adapters' B drawn away from 0 so that the merge matters) go through
both `load_pretrained_model`s (`model_path=""`, `tiny=True`) at bits 16,
8 and 4 (int4: absmax scales, `CLIP_SEARCH`). The JAX function's fresh
init (`_init_params`) is replaced, in this test only, by that tree (the
file overwrites every leaf of it anyway). The tree is a port Setokim's
seeded weights in the flax layout (`to_flax_tree`), made once at module
scope: no flax init to compile. Bars: the prefill logits within the
serving bar of tests/test_torch_setokim.py (2e-3 max-rel; 1e-4 at bits
16, float32), and at bits 8 the int8 trunk buffers identical. The stage-2 checkpoint
path: a port trainer's checkpoint loads with its adapters merged and no
read of its optimizer file; and the CLIs: the stage-2 CLI's `--output-dir`
loaded by the serving CLI and the demo (`--checkpoint`, `--image`).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.models import builder as jbuilder
from setok_tpu.train.lora import init_lora as j_init_lora
from setok_tpu.utils import checkpoint as jckpt
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.models.builder import load_pretrained_model
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.train.stage2 import Stage2Trainer
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.from_flax import to_flax_tree
from setok_tpu_torch.utils.init import init_setokim_random_
from setok_tpu_torch.utils.porting import load_flat_into
from tests.test_torch_setokim import MAX_LEN, prompts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BARS = {16: 1e-4, 8: 2e-3, 4: 2e-3}
# the int4 scales by plain absmax (clip search 0): the default search over
# 8 ratios costs the JAX builder ~7 s on the CPU; the searched scales are
# held to the JAX package's in tests/test_torch_quant.py
CLIP_SEARCH = 0
IDS, IMAGES = prompts(3)
# the file's tiny Setokim flax tree (numpy leaves)
SETOKIM_TREE = to_flax_tree(init_setokim_random_(
    Setokim(tcfg.tiny_setokim(), target_token_id=3, device="cpu"), 11))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("builder")
    params = jax.tree.map(jnp.asarray, SETOKIM_TREE)
    whole = str(d / "whole.npz")
    jckpt.save_subtree(whole, params, lambda name: True)
    lora = j_init_lora(params, jax.random.PRNGKey(3), 4)
    rs = np.random.RandomState(4)
    flat = {}
    for path, ab in lora.items():
        flat[f"{path}/a"] = np.asarray(ab["a"])
        flat[f"{path}/b"] = (0.05 * rs.randn(*ab["b"].shape)).astype(
            np.float32)
    lora_npz = str(d / "lora.npz")
    np.savez(lora_npz, **flat)
    return whole, lora_npz, len(np.load(whole).files)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_builder_matches_jax(files, bits, monkeypatch):
    whole, lora_npz, n_leaves = files
    monkeypatch.setattr(jbuilder, "_init_params", lambda model, cfg: jax.tree
                        .map(jnp.asarray, SETOKIM_TREE))
    jm, jp = jbuilder.load_pretrained_model(
        "", projector_path=whole, lora_path=lora_npz, lora_r=4,
        lora_alpha=8.0, tiny=True, bits=bits, clip_search=CLIP_SEARCH)
    want = jax.jit(lambda p, i, im: jm.apply(
        p, i, im, MAX_LEN, method=jm.prefill))(
        jp, jnp.asarray(IDS), jnp.asarray(IMAGES))[0]

    model = load_pretrained_model("", projector_path=whole,
                                  lora_path=lora_npz, lora_r=4,
                                  lora_alpha=8.0, tiny=True, bits=bits,
                                  clip_search=CLIP_SEARCH, device="cpu")
    if bits == 16:      # the whole-tree file fills every entry of the port's
        assert n_leaves == len(model.state_dict())
    with torch.no_grad():
        got = model.prefill(torch.from_numpy(IDS), torch.from_numpy(IMAGES),
                            MAX_LEN)[0]
    assert max_rel(got.numpy(), want) <= BARS[bits]
    if bits == 8:
        layer = jp["params"]["llama"]["model"]["layer_0"]
        for mod, name in (("attn", "q_proj"), ("mlp", "down_proj")):
            jq = np.asarray(layer[mod][name]["q"])
            tq = getattr(getattr(model.llama.model.layer_0, mod), name).q
            np.testing.assert_array_equal(tq.numpy(), jq.T)


def test_pretrain_npz_loads_by_suffix(files):
    """The stage-2 CLI's `--pretrain-*` load (`load_flat_into`): the
    projector's arrays of a JAX-written file fill that module alone."""
    whole, _, _ = files
    flat = {k: v for k, v in np.load(whole).items()
            if "mm_in_projector" in k}
    model = init_setokim_random_(Setokim(tcfg.tiny_setokim(),
                                         target_token_id=3, device="cpu"), 5)
    before = to_flax_tree(model)["params"]
    assert load_flat_into(model, flat, strict=True) == []
    after = to_flax_tree(model)["params"]
    for name in after:
        want = SETOKIM_TREE["params"] if name == "mm_in_projector" \
            else before
        for got, ref in zip(jax.tree.leaves(after[name]),
                            jax.tree.leaves(want[name])):
            np.testing.assert_array_equal(got, ref)


def test_builder_reads_a_port_stage2_checkpoint(tmp_path):
    tr = Stage2Trainer(tcfg.tiny_setokim(), target_token_id=3,
                       lora_enable=True, lora_r=4, lora_alpha=8.0,
                       device="cpu")
    init_setokim_random_(tr.model, 7)
    tr.init_state(seed=8)
    with torch.no_grad():
        for _, b in tr.lora.values():
            b.normal_(0, 0.05, generator=torch.Generator().manual_seed(9))
    ckpt.save_checkpoint(str(tmp_path / "checkpoints"), 4, tr.state_dict())
    os.remove(tmp_path / "checkpoints" / "4" / "train.pt")
    model = load_pretrained_model(str(tmp_path), tiny=True, lora_r=4,
                                  lora_alpha=8.0, device="cpu")
    merged = tr.merged_params()
    own = model.state_dict()
    assert set(own) == set(merged)
    assert all(torch.equal(own[k], merged[k]) for k in own)


def test_train_save_load_serve_cli(tmp_path, capsys):
    """train → save → load → serve through the CLIs: the stage-2 CLI writes
    its checkpoint under --output-dir, the serving CLI and the demo load it
    through the builder (bits 8), the demo also reads a PNG."""
    from PIL import Image

    from setok_tpu_torch.scripts import demo, serve, train_setokim
    run = str(tmp_path / "run")
    train_setokim.main(["--cpu", "--tiny", "--synthetic", "--steps", "2",
                        "--batch-size", "2", "--model-max-length", "48",
                        "--lora-enable", "--lora-r", "4", "--output-dir",
                        run])
    assert ckpt.latest_step(os.path.join(run, "checkpoints")) == 2
    serve.main(["--cpu", "--tiny", "--checkpoint", run, "--bits", "8",
                "--max-new-tokens", "3", "--prompt-len", "16", "--max-len",
                "24"])
    assert "4 requests, 12 tokens" in capsys.readouterr().out
    png = str(tmp_path / "x.png")
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 30, 3)).astype(np.uint8)).save(png)
    demo.main(["--tiny", "--cpu", "--checkpoint", run, "--image", png,
               "--max-new-tokens", "2"])
    out = capsys.readouterr().out
    assert "[tokenize]" in out and "[image-gen]" in out
