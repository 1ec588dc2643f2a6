"""The port's last utilities against the JAX package on the CPU:
`ops/blocks.CrossAttention`, `utils/tokens.py` (vocabulary growth) and
`utils/compile_cache.py` (the kernels' build directory of the CLIs'
`--compile-cache`).

The same seeded numpy inputs go through both packages, the flax weights
taken from the port's modules (`to_flax_tree`, no flax init). Bars: the
attention 1e-5 max-abs in float32 (sums in another order); the grown
tables 1e-6 relative (a mean over the rows in another order), the rows
that were there bit for bit; the cache's directories exactly as
tests/test_compile_cache.py::test_off_and_auto_resolution resolves them.
"""

import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from setok_tpu.ops.blocks import CrossAttention as JCrossAttention
from setok_tpu.utils import tokens as jtokens
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.kernels import _build
from setok_tpu_torch.models.llama import LlamaForCausalLM
from setok_tpu_torch.ops.blocks import CrossAttention
from setok_tpu_torch.scripts import (demo, eval_recon, serve, train_setok,
                                     train_setokim)
from setok_tpu_torch.utils import compile_cache, tokens
from setok_tpu_torch.utils.from_flax import from_flax, to_flax_tree
from setok_tpu_torch.utils.init import init_random_
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def attention_inputs(b=3, n=5, m=7, c=32, c_ctx=24, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, c).astype(np.float32)
    ctx = rs.randn(b, m, c_ctx).astype(np.float32)
    mask = rs.rand(b, m) > 0.4
    mask[0] = True
    mask[1] = False                       # every key of row 1 masked
    return x, ctx, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "keymask"])
def test_cross_attention_matches_jax(masked):
    x, ctx, mask = attention_inputs()
    model = init_random_(CrossAttention(32, 4, context_dim=24,
                                        device="cpu"), 3)
    tree = to_flax_tree(model)
    jm = JCrossAttention(num_heads=4)
    want = np.asarray(jm.apply(tree, jnp.asarray(x), jnp.asarray(ctx),
                               jnp.asarray(mask) if masked else None))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ctx),
                    torch.from_numpy(mask) if masked else None).numpy()
    assert got.shape == want.shape == (3, 5, 32)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= TOL
    if masked:
        # a fully masked row weighs every key evenly: proj(mean of v)
        with torch.no_grad():
            kv = model.kv(torch.from_numpy(ctx[1]))
            v = kv[:, 32:].mean(0)
            mean_v = model.proj(v).numpy()
        assert float(np.abs(got[1] - mean_v[None]).max()) <= TOL
        assert float(np.abs(got[1]).max()) > 0.0


def test_cross_attention_without_qkv_bias_has_the_jax_tree():
    model = CrossAttention(16, 2, qkv_bias=False, device="cpu")
    params = to_flax_tree(model)["params"]
    assert set(params) == {"q", "kv", "proj"}
    assert set(params["q"]) == set(params["kv"]) == {"kernel"}
    assert set(params["proj"]) == {"kernel", "bias"}
    x, ctx, _ = attention_inputs(c=16, c_ctx=16)
    want = JCrossAttention(num_heads=2, qkv_bias=False).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    assert float(np.abs(got - np.asarray(want)).max()) <= TOL


def tiny_trunk():
    return init_random_(LlamaForCausalLM(tcfg.tiny_llama(), device="cpu"), 4)


def test_resize_token_embeddings_matches_jax():
    model = tiny_trunk()
    state = model.state_dict()
    want = from_flax(jax.tree.map(np.asarray, jtokens.resize_token_embeddings(
        to_flax_tree(model), 4)))
    got = tokens.resize_token_embeddings(state, 4)
    assert sorted(got) == sorted(want)
    vocab = tcfg.tiny_llama().vocab_size
    for key in ("embed_tokens.weight", "lm_head.weight"):
        assert got[key].shape == (vocab + 4, 64)       # rows in (out, in)
        assert torch.equal(got[key][:vocab], state[key])
        scale = float(want[key].abs().max())
        assert float((got[key] - want[key]).abs().max()) <= 1e-6 * scale
    for key, value in state.items():
        if key not in ("embed_tokens.weight", "lm_head.weight"):
            assert got[key] is value
    # a trunk of the grown vocabulary loads it
    grown = LlamaForCausalLM(tcfg.replace(tcfg.tiny_llama(),
                                          vocab_size=vocab + 4),
                             device="cpu")
    grown.load_state_dict(got, strict=True)
    assert tokens.resize_token_embeddings(state, 0) is state


class ToyTokenizer:
    """HF-style `add_tokens` / `convert_tokens_to_ids` over a vocabulary."""

    def __init__(self, size):
        self.vocab = {f"t{i}": i for i in range(size)}

    def add_tokens(self, toks, special_tokens=False):
        new = [t for t in toks if t not in self.vocab]
        for t in new:
            self.vocab[t] = len(self.vocab)
        return len(new)

    def convert_tokens_to_ids(self, tok):
        return self.vocab[tok]


@pytest.mark.parametrize("start_end", [True, False])
def test_add_special_tokens_matches_jax(start_end):
    model = tiny_trunk()
    vocab = tcfg.tiny_llama().vocab_size
    jstate, jids = jtokens.add_special_tokens(
        ToyTokenizer(vocab), to_flax_tree(model), start_end)
    state, ids = tokens.add_special_tokens(ToyTokenizer(vocab),
                                           model.state_dict(), start_end)
    assert ids == jids and len(ids) == (4 if start_end else 2)
    assert sorted(ids.values()) == list(range(vocab, vocab + len(ids)))
    want = from_flax(jax.tree.map(np.asarray, jstate))
    for key in ("embed_tokens.weight", "lm_head.weight"):
        assert state[key].shape == want[key].shape == (vocab + len(ids), 64)
    # nothing new to add: nothing grows
    tok = ToyTokenizer(vocab)
    tokens.add_special_tokens(tok, model.state_dict(), start_end)
    again, _ = tokens.add_special_tokens(tok, model.state_dict(), start_end)
    assert again["embed_tokens.weight"].shape == (vocab, 64)
    assert set(tokens.SPECIAL_TOKENS) == set(jtokens.SPECIAL_TOKENS)


@pytest.fixture
def build_dir_restored(monkeypatch):
    """`_build.BUILD_DIR` as it was after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)


def test_off_and_auto_resolution(tmp_path, monkeypatch, build_dir_restored):
    """off / "" → a new directory of the process's own each time; auto →
    $SETOK_COMPILE_CACHE, else the checkout's build/torch_kernels; a path →
    that directory; the libraries are then looked up there."""
    offs = {compile_cache.enable_compilation_cache(v) for v in ("off", "")}
    assert len(offs) == 2 and all(os.path.isdir(d) for d in offs)
    assert not offs & {compile_cache.DEFAULT_DIR}
    monkeypatch.setenv("SETOK_COMPILE_CACHE", str(tmp_path / "via_env"))
    d = compile_cache.enable_compilation_cache("auto")
    assert d == str(tmp_path / "via_env") and os.path.isdir(d)
    assert compile_cache.enable_compilation_cache(None) == d
    monkeypatch.delenv("SETOK_COMPILE_CACHE")
    assert compile_cache.enable_compilation_cache("auto") == \
        compile_cache.DEFAULT_DIR == str(
            Path(__file__).resolve().parents[1] / "build" / "torch_kernels")
    d = compile_cache.enable_compilation_cache(str(tmp_path / "mine"))
    assert d == str(tmp_path / "mine") and os.path.isdir(d)
    assert _build.BUILD_DIR == tmp_path / "mine"
    assert _build._library_path("cluster_dpc").parent == tmp_path / "mine"


@pytest.mark.parametrize("cli", [serve, train_setok, train_setokim,
                                 eval_recon, demo],
                         ids=["serve", "train_setok", "train_setokim",
                              "eval_recon", "demo"])
def test_clis_take_the_flag(cli):
    """The five CLIs take --compile-cache, default auto, as in JAX."""
    base = {train_setok: ["--synthetic", "4"],
            train_setokim: ["--synthetic"],
            eval_recon: ["--synthetic", "4"]}.get(cli, [])
    assert cli.parse_args(base).compile_cache == "auto"
    assert cli.parse_args([*base, "--compile-cache", "off"]) \
        .compile_cache == "off"
