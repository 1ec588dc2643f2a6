"""The benchmark's plain reference against the port's float path, on the CPU.

At tiny sizes, on the same weights (drawn by h100_bench/weights.py) and the
same images, the reference's clustering, tokens and reconstruction equal
the port's float32 forward; its parameter list names every leaf of the
port's models at the benchmark's configurations. The card test runs the
same comparison on the card (marker `cuda`: it skips without one).

    python -m pytest -q h100_bench/tests
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from h100_bench import check, harness, images, weights
from h100_bench.reference import setok_ref as R

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny_config(min_clusters: int = 4, threshold: float = 0.55,
                param_dtype: str = "float32") -> dict:
    from setok_tpu_torch import config as C
    tok = dataclasses.replace(C.tiny_tokenizer(), min_cluster_num=min_clusters,
                              threshold=threshold)
    t = dataclasses.asdict(tok)
    v = t.pop("vit")
    return {"name": "tiny", "source": "test", "param_dtype": param_dtype,
            "compute_dtype": "float32", "vit": v, "tokenizer": t,
            "detokenizer": dataclasses.asdict(C.tiny_detokenizer()),
            "reduced": []}


def port_model(cfg: dict, seed: int, device="cpu"):
    from setok_tpu_torch.config import (DetokenizerConfig, TokenizerConfig,
                                        ViTConfig)
    from setok_tpu_torch.models.setok import SeTok
    tok = TokenizerConfig(vit=ViTConfig(**cfg["vit"]), **cfg["tokenizer"])
    model = SeTok(tok, DetokenizerConfig(**cfg["detokenizer"]),
                  device=device,
                  param_dtype=getattr(torch, cfg["param_dtype"]))
    spec = R.param_spec(cfg)
    for part in weights.PARTS:
        weights.load_into(getattr(model, part), spec[part], seed, part,
                          getattr(torch, cfg["param_dtype"]), device)
    return model


@pytest.mark.parametrize("name", ["setok-base256", "setok-so400m", "tiny"])
def test_param_spec_names_every_leaf_of_the_port(name):
    from setok_tpu_torch.config import (DetokenizerConfig, TokenizerConfig,
                                        ViTConfig)
    from setok_tpu_torch.models.setok import SeTok
    cfg = (tiny_config() if name == "tiny" else
           json.loads((ROOT / "configs" / f"{name}.json").read_text()))
    tok = TokenizerConfig(vit=ViTConfig(**cfg["vit"]), **cfg["tokenizer"])
    model = SeTok(tok, DetokenizerConfig(**cfg["detokenizer"]), device="meta")
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    spec = {f"{part}.{k}": s for part, leaves in R.param_spec(cfg).items()
            for k, s in leaves}
    assert spec == port


@pytest.mark.parametrize("seed,min_clusters,threshold", [
    (0, 4, 0.55), (2 ** 31 + 17, 4, 0.55), (5, 8, 1e9), (6, 3, 1e9)])
def test_reference_equals_the_port_float_path(seed, min_clusters, threshold):
    """Identical clusters, and tokens and reconstruction to float32
    rounding (the same products in the same order: the readings are 0)."""
    cfg = tiny_config(min_clusters, threshold)
    model = port_model(cfg, seed)
    x = images.image_pool(seed, 1, 4, cfg["vit"]["image_size"], False)[0]
    with torch.no_grad():
        out = model(x)
    ref = check.Reference(cfg, seed, weights.PARTS, "cpu")
    mine = ref.outputs(x)
    assert torch.equal(mine["idx_cluster"], out.idx_cluster)
    assert torch.equal(mine["num_clusters"], out.num_clusters)
    assert torch.equal(mine["token_valid"], out.token_valid)
    assert check.rel_err(out.tokens, mine["tokens"]) < 1e-6
    assert check.rel_err(out.recon, mine["recon"]) < 1e-6
    with torch.no_grad():
        got = dict(out._asdict(), score=model.tokenizer(x).score,
                   features=model.tokenizer.encode_features(x))
    recon = harness.load_module(ROOT, "modes", "recon")
    numbers = recon.judge(ref, x, got)
    assert numbers["row1_assign"] == 0.0 and numbers["row1_score"] < 1e-6
    assert numbers["token_err"] < 1e-6 and numbers["recon_err"] < 1e-6


def test_reference_reads_bf16_weights_as_the_program_holds_them():
    cfg = tiny_config(param_dtype="bfloat16")
    model = port_model(cfg, 9)
    ref = check.Reference(cfg, 9, weights.PARTS, "cpu")
    for k, v in model.tokenizer.state_dict().items():
        assert torch.equal(v.float(), ref.tok.w[k]), k


def test_posenc_equals_the_port():
    from setok_tpu_torch.ops.posenc import posenc_2d_flat
    for g, c in ((16, 768), (27, 4096), (18, 4096), (4, 30)):
        assert torch.allclose(R.posenc_2d(g, g, c, "cpu"),
                              posenc_2d_flat(g, g, c), atol=1e-6, rtol=0)


def test_the_w4a8_control_departs_from_the_reference():
    cfg = tiny_config()
    x = images.image_pool(1, 1, 4, cfg["vit"]["image_size"], False)[0]
    ref = check.Reference(cfg, 1, weights.PARTS, "cpu")
    low = check.Reference(cfg, 1, weights.PARTS, "cpu", quant="w4a8")
    assert check.rel_err(low.outputs(x)["recon"],
                         ref.outputs(x)["recon"]) > 1e-2


def test_int4_int8_and_fp8_round_to_their_grids():
    x = torch.tensor([[7.0, -3.4, 0.49, 1.0]])
    assert torch.equal(R.int4(x, -1), torch.tensor([[7.0, -3.0, 0.0, 1.0]]))
    y = torch.tensor([[127.0, -3.4, 0.49, 1.0]])
    assert torch.equal(R.int8(y, -1), torch.tensor([[127.0, -3.0, 0.0, 1.0]]))
    y = R.fp8(torch.tensor([[448.0, 1.0, 0.3]]), -1)
    assert y[0, 0] == 448.0 and y[0, 1] == 1.0 and abs(y[0, 2] - 0.3) < 0.02


@pytest.mark.cuda
def test_reference_matches_the_port_on_the_card():
    """The card draws its own weights from the seed (another generator
    than the CPU's), so both sides run there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tiny_config()
    x = images.image_pool(3, 1, 4, cfg["vit"]["image_size"], False)[0]
    card = check.Reference(cfg, 3, weights.PARTS, "cuda").outputs(x.cuda())
    model = port_model(cfg, 3, "cuda")
    with torch.no_grad():
        out = model(x.cuda())
    assert torch.equal(out.idx_cluster, card["idx_cluster"])
    assert check.rel_err(out.recon, card["recon"]) < 1e-5
