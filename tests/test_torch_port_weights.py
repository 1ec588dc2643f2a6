"""The port's weight porting (setok_tpu_torch/scripts/port_weights.py)
against the JAX package's scripts/port_weights.py on the CPU.

The state dicts are in the HF key layout, written by chip_smoke.py's
writers (the code that writes the card phase's files at the public
geometries) at tiny geometries from a seeded generator; where
`transformers` imports, tiny HF models too. Bars: the porters' files bit
for bit (the same keys, dtypes and arrays); the port's `.safetensors`
reader against `safetensors.numpy.load_file`, exactly; the port's ViT,
Llama, QFormer and LPIPS loaded from the port's files against the JAX
modules loaded from the JAX script's files, at tests/test_port_weights.py's
bars (2e-4 the ViT, 2e-3 the Llama; 1e-4 the QFormer and LPIPS, the float
forward's bar of tests/test_torch_models.py).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from setok_tpu import config as jcfg
from setok_tpu.losses.lpips import LPIPS as JLPIPS
from setok_tpu.models.llama import LlamaForCausalLM as JLlama
from setok_tpu.models.qformer import QFormer as JQFormer
from setok_tpu.models.vit import ViT as JViT
from setok_tpu.utils.porting import load_flat_into as j_load_flat_into
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.losses.lpips import LPIPS
from setok_tpu_torch.models.llama import LlamaForCausalLM
from setok_tpu_torch.models.qformer import QFormer
from setok_tpu_torch.models.vit import ViT
from setok_tpu_torch.scripts import port_weights as pw
from setok_tpu_torch.utils.from_flax import to_flax_tree
from setok_tpu_torch.utils.init import init_random_
from setok_tpu_torch.utils.porting import load_flat_into
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]

# tiny geometries of the modules they load into (tiny_tokenizer's ViT,
# tiny_llama, QFormers of width 32; BERT keeps the 6 layers the CLI ports)
SIGLIP = dict(width=32, layers=2, mlp=128, patch=8, image=32)
BERT = dict(width=32, layers=6, mlp=128, vocab=64, positions=32)
LLAMA = dict(vocab=512, hidden=64, mlp=128, layers=2)


def jax_script(name: str):
    """The JAX package's scripts/<name>.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def state_dicts(seed: int = 0) -> dict:
    """The four HF-layout state dicts (torch tensors), LLaMA in fp16."""
    gen = torch.Generator().manual_seed(seed)
    return {"siglip": cs.hf_siglip_state(gen, **SIGLIP),
            "bert": cs.hf_bert_state(gen, **BERT),
            "vgg": cs.hf_vgg_lpips_state(gen),
            "llama": cs.hf_llama_state(gen, **LLAMA)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The state dicts as files: SigLIP .safetensors (chip_smoke's
    writer), the others torch.save'd (.bin, .pth)."""
    root = tmp_path_factory.mktemp("hf")
    sds = state_dicts()
    paths = {"siglip": root / "siglip.safetensors", "bert": root / "bert.bin",
             "vgg": root / "vgg16_lpips.pth", "llama": root / "llama.bin"}
    cs.write_safetensors(paths["siglip"], sds["siglip"])
    for name in ("bert", "vgg", "llama"):
        torch.save(sds[name], paths[name])
    return {k: str(v) for k, v in paths.items()}, sds


SOURCES = {"siglip": "siglip", "llama": "llama", "vgg16": "vgg",
           "lpips_lins": "vgg", "qformer": "bert"}


@pytest.fixture(scope="module")
def ported(files, tmp_path_factory):
    """Each porter's file by both CLIs: {kind: (port npz, JAX npz)}."""
    paths, _ = files
    root = tmp_path_factory.mktemp("ported")
    jpw = jax_script("port_weights")
    out = {}
    for kind, src in SOURCES.items():
        mine, theirs = root / f"{kind}.npz", root / f"{kind}.jax.npz"
        pw.main([kind, paths[src], str(mine)])
        argv = sys.argv
        sys.argv = ["port_weights.py", kind, paths[src], str(theirs)]
        try:
            jpw.main()
        finally:
            sys.argv = argv
        out[kind] = (dict(np.load(mine)), dict(np.load(theirs)))
    return out


@pytest.mark.parametrize("kind", list(SOURCES))
def test_porters_write_the_jax_files_bit_for_bit(kind, ported):
    mine, theirs = ported[kind]
    assert list(mine) == list(theirs) and mine
    for key, want in theirs.items():
        got = mine[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert np.array_equal(got, want), key


def test_siglip_head_and_post_norm_are_skipped(files, ported):
    """The file holds the post-layernorm and the pooling head; the porter
    takes the patch embed, the positions and every encoder layer."""
    _, sds = files
    assert any("head." in k for k in sds["siglip"])
    mine, _ = ported["siglip"]
    assert len(mine) == 3 + 12 * SIGLIP["layers"]
    assert mine["patch_embed/kernel"].shape == (8, 8, 3, 32)


def test_safetensors_reader_matches_the_package(tmp_path, files):
    st = pytest.importorskip("safetensors.numpy")
    rs = np.random.RandomState(3)
    arrays = {"f32": rs.randn(3, 5).astype(np.float32),
              "f16": rs.randn(7).astype(np.float16),
              "f64": rs.randn(2, 2, 2),
              "i64": rs.randint(-9, 9, (4, 3)).astype(np.int64),
              "i8": rs.randint(-128, 127, 6).astype(np.int8),
              "u8": rs.randint(0, 255, 5).astype(np.uint8),
              "bool": rs.rand(3) > 0.5,
              "scalar": np.array(2.5, np.float32),
              "empty": np.zeros((0, 4), np.float32)}
    path = tmp_path / "mixed.safetensors"
    st.save_file(arrays, str(path), metadata={"format": "np"})
    got, want = pw.load_safetensors(str(path)), st.load_file(str(path))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key
    # chip_smoke's writer makes files the package reads as written
    paths, sds = files
    theirs = st.load_file(paths["siglip"])
    assert sorted(theirs) == sorted(sds["siglip"])
    for key, t in sds["siglip"].items():
        assert np.array_equal(theirs[key], t.numpy()), key


def test_bf16_is_widened_exactly(tmp_path):
    """bf16 (no numpy type) comes out as the float32 values it stands for,
    from .safetensors and from torch.save alike."""
    t = {"w": torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
         .to(torch.bfloat16), "b": torch.arange(3, dtype=torch.float16)}
    cs.write_safetensors(tmp_path / "x.safetensors", t)
    torch.save({"state_dict": t}, tmp_path / "x.pth")
    for name in ("x.safetensors", "x.pth"):
        got = pw.load_state_dict(str(tmp_path / name))
        assert got["w"].dtype == np.float32
        assert np.array_equal(got["w"], t["w"].float().numpy())
        assert got["b"].dtype == np.float16
        assert np.array_equal(got["b"], t["b"].numpy())


def max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def loaded(model, mine, theirs):
    """`model` (seeded) filled from the port's file, and the flax tree of
    its seeded weights filled from the JAX file; every key must match."""
    tree = jax.tree.map(jnp.asarray, to_flax_tree(model))
    tree, unmatched = j_load_flat_into(tree, theirs)
    assert not unmatched, unmatched
    assert not load_flat_into(model, mine)
    return model, tree


def test_loaded_vit_matches_jax(ported):
    cfg_t = tcfg.replace(tcfg.tiny_tokenizer().vit, select_layer=-1)
    cfg_j = jcfg.replace(jcfg.tiny_tokenizer().vit, select_layer=-1)
    model = init_random_(ViT(cfg_t, device="cpu"), 5)
    model, tree = loaded(model, *ported["siglip"])
    x = np.random.RandomState(0).uniform(-1, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    want = np.asarray(JViT(cfg_j).apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert max_rel(got, want) <= 2e-4


def test_loaded_llama_matches_jax(ported):
    model = init_random_(LlamaForCausalLM(tcfg.tiny_llama(), device="cpu"),
                         6)
    model, tree = loaded(model, *ported["llama"])
    ids = np.random.RandomState(1).randint(3, 512, (2, 10))
    want, _, _ = JLlama(jcfg.tiny_llama()).apply(tree, jnp.asarray(ids))
    with torch.no_grad():
        got, _, _ = model(torch.from_numpy(ids))
    assert max_rel(got, np.asarray(want)) <= 2e-3


def test_loaded_qformer_matches_jax(files):
    """BERT's first 2 layers fill the self-attention, the FFN and the
    embedding norm; the cross-attention keeps the seeded weights on both
    sides."""
    _, sds = files
    sd = {k: v.numpy() for k, v in sds["bert"].items()}
    model = init_random_(QFormer(32, num_layers=2, num_heads=2, dropout=0.0,
                                 attn_dropout=0.0, device="cpu"), 7)
    model, tree = loaded(model, pw.port_qformer_bert(sd, num_layers=2),
                         jax_script("port_weights").port_qformer_bert(
                             sd, num_layers=2))
    rs = np.random.RandomState(2)
    q = rs.randn(2, 4, 32).astype(np.float32)
    enc = rs.randn(2, 6, 32).astype(np.float32)
    want = np.asarray(JQFormer(num_layers=2, num_heads=2,
                               cross_attention_freq=2).apply(
        tree, jnp.asarray(q), jnp.asarray(enc)))
    with torch.no_grad():
        got = model(torch.from_numpy(q), torch.from_numpy(enc)).numpy()
    assert max_rel(got, want) <= 1e-4


def test_loaded_lpips_matches_jax(ported):
    """The VGG convolutions and the lin heads, one file of both porters
    (what train_setok --lpips-weights reads)."""
    mine = {**ported["vgg16"][0], **ported["lpips_lins"][0]}
    theirs = {**ported["vgg16"][1], **ported["lpips_lins"][1]}
    model, tree = loaded(LPIPS(device="cpu"), mine, theirs)
    rs = np.random.RandomState(4)
    a = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = float(JLPIPS().apply(tree, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = float(model(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-4 * abs(want)


def hf_transformers(monkeypatch):
    """`transformers`, or a skip; imported without its TensorFlow side
    (which its model classes would otherwise load, some 10 s)."""
    monkeypatch.setenv("USE_TF", "0")
    return pytest.importorskip("transformers")


def test_writers_have_the_hf_layout(monkeypatch):
    """chip_smoke's writers give the keys and shapes of the HF models
    themselves (tiny configs; SigLIP's head and post-norm, BERT's pooler
    included)."""
    transformers = hf_transformers(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    cases = [
        (transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
            hidden_size=32, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=2, image_size=32, patch_size=8)),
         cs.hf_siglip_state(gen, **SIGLIP)),
        (transformers.BertModel(transformers.BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=6,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=32)), cs.hf_bert_state(gen, **BERT)),
        (transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, tie_word_embeddings=False)),
         cs.hf_llama_state(gen, **LLAMA))]
    for hf, sd in cases:
        want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_hf_models_load_into_the_port_as_into_hf(monkeypatch):
    """Tiny HF SigLIP and LLaMA models through the port's porters into the
    port's ViT and Llama give HF's own forward (the JAX test's bars)."""
    transformers = hf_transformers(monkeypatch)
    torch.manual_seed(0)
    sig = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=8)).eval()
    vit = ViT(tcfg.replace(tcfg.tiny_tokenizer().vit, select_layer=-1),
              device="cpu")
    sd = {k: v.detach().numpy() for k, v in sig.state_dict().items()}
    assert not load_flat_into(vit, pw.port_siglip_vision(sd))
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = vit(torch.from_numpy(x)).numpy()
        want = sig(torch.from_numpy(x).permute(0, 3, 1, 2),
                   output_hidden_states=True).hidden_states[-1].numpy()
    assert max_rel(got, want) <= 2e-4

    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=256, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attn_implementation="eager")).eval()
    llama = LlamaForCausalLM(tcfg.tiny_llama(), device="cpu")
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    assert not load_flat_into(llama, pw.port_llama(sd))
    ids = np.random.RandomState(1).randint(3, 512, (2, 10))
    with torch.no_grad():
        got, _, _ = llama(torch.from_numpy(ids))
        want = hf(torch.from_numpy(ids)).logits
    assert max_rel(got, want) <= 2e-3
