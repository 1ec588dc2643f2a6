"""Port pretrained torch checkpoints into flat flax-layout weight files.

    python -m setok_tpu_torch.scripts.port_weights siglip  model.safetensors out.npz
    python -m setok_tpu_torch.scripts.port_weights llama   pytorch_model.bin out.npz
    python -m setok_tpu_torch.scripts.port_weights vgg16   vgg16.pth out.npz
    python -m setok_tpu_torch.scripts.port_weights lpips_lins vgg.pth out.npz
    python -m setok_tpu_torch.scripts.port_weights qformer bert.bin out.npz

The counterpart of the JAX package's `scripts/port_weights.py`, with its CLI
and its five porters. The reference pulls its backbones from the HF hub at
run time (SigLIP, BERT for the Q-Former mapper, VGG16 + the LPIPS heads,
Vicuna/LLaMA); offline, porting is a step of its own: each porter turns one
torch state dict (HF key layout) into a flat {'a/b/c': array} `.npz` in the
flax layout (Dense kernels (in, out), convolutions HWIO, HF's separate
q/k/v concatenated into `qkv`). Such a file loads into either package by
path suffix (`utils/porting.load_flat_into`, the JAX `load_flat_into`,
`train_setokim --pretrain-*`, `train_setok --lpips-weights`), and
`scripts/assemble_pretrained.py` splices them into a Setokim.

Mappings (torch name → flax path of the port's module):
  SigLIP vision tower → models/vit.ViT (the patch embed as flax's HWIO
                        convolution kernel, which `from_flax` turns into
                        the ViT's patchify matmul)
  HF llama            → models/llama.LlamaForCausalLM
  torchvision vgg16   → losses/lpips.VGG16Features (+ the lin heads)
  bert (stripped)     → models/qformer.QFormer

`load_state_dict` reads one file, as the JAX script does: a `.safetensors`
file by its own format (an 8-byte header length, a JSON header of dtype,
shape and byte offsets, then the raw little-endian bytes), read with numpy
alone, so that no `safetensors` package is needed; any other file by
`torch.load(weights_only=True)`, its `state_dict` entry where it has one.
bf16 tensors (which numpy has no type for) are widened to float32, which
is exact; every other type keeps its own.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np

# safetensors dtype names → numpy types (BF16 is read as uint16 payloads)
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_, "BF16": np.uint16,
}


def bf16_to_f32(payload: np.ndarray) -> np.ndarray:
    """uint16 bf16 payloads → the float32 values they stand for (exact)."""
    return (payload.astype(np.uint32) << 16).view(np.float32)


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A `.safetensors` file as {name: numpy array}, bf16 widened to
    float32."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    size = os.path.getsize(path) - 8 - n
    data = (np.memmap(path, np.uint8, "r", offset=8 + n, shape=(size,))
            if size else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        kind = info["dtype"]
        if kind not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {kind}, which this "
                             "reader does not take")
        begin, end = info["data_offsets"]
        little = np.dtype(_SAFETENSORS_DTYPES[kind]).newbyteorder("<")
        arr = data[begin:end].view(little).reshape(info["shape"])
        out[name] = (bf16_to_f32(arr) if kind == "BF16"
                     else arr.astype(little.newbyteorder("="), copy=True))
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch .bin/.pth/.safetensors state dict as numpy arrays."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in sd.items()}


def _t(x):
    """torch Linear weight (out, in) → flax kernel (in, out)."""
    return np.ascontiguousarray(np.asarray(x).T)


def port_siglip_vision(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF SiglipVisionModel → ViT param paths (as flat 'a/b/c' keys); the
    post-layernorm and the pooling head have no place in the ViT."""
    p = "vision_model."
    out: Dict[str, np.ndarray] = {}
    # conv patch embed: torch (out, in, kh, kw) → flax (kh, kw, in, out)
    w = sd[p + "embeddings.patch_embedding.weight"]
    out["patch_embed/kernel"] = np.transpose(w, (2, 3, 1, 0))
    out["patch_embed/bias"] = sd[p + "embeddings.patch_embedding.bias"]
    out["pos_embed"] = sd[p + "embeddings.position_embedding.weight"][None]
    i = 0
    while f"{p}encoder.layers.{i}.layer_norm1.weight" in sd:
        q = f"{p}encoder.layers.{i}."
        b = f"block_{i}/"
        out[b + "norm1/scale"] = sd[q + "layer_norm1.weight"]
        out[b + "norm1/bias"] = sd[q + "layer_norm1.bias"]
        out[b + "norm2/scale"] = sd[q + "layer_norm2.weight"]
        out[b + "norm2/bias"] = sd[q + "layer_norm2.bias"]
        # fused qkv: concat HF's separate q/k/v
        qw = sd[q + "self_attn.q_proj.weight"]
        kw = sd[q + "self_attn.k_proj.weight"]
        vw = sd[q + "self_attn.v_proj.weight"]
        out[b + "attn/qkv/kernel"] = _t(np.concatenate([qw, kw, vw], 0))
        out[b + "attn/qkv/bias"] = np.concatenate(
            [sd[q + "self_attn.q_proj.bias"],
             sd[q + "self_attn.k_proj.bias"],
             sd[q + "self_attn.v_proj.bias"]], 0)
        out[b + "attn/proj/kernel"] = _t(sd[q + "self_attn.out_proj.weight"])
        out[b + "attn/proj/bias"] = sd[q + "self_attn.out_proj.bias"]
        out[b + "mlp/fc1/kernel"] = _t(sd[q + "mlp.fc1.weight"])
        out[b + "mlp/fc1/bias"] = sd[q + "mlp.fc1.bias"]
        out[b + "mlp/fc2/kernel"] = _t(sd[q + "mlp.fc2.weight"])
        out[b + "mlp/fc2/bias"] = sd[q + "mlp.fc2.bias"]
        i += 1
    return out


def port_llama(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF LlamaForCausalLM → LlamaForCausalLM param paths."""
    out: Dict[str, np.ndarray] = {}
    out["embed_tokens/embedding"] = sd["model.embed_tokens.weight"]
    if "lm_head.weight" in sd:
        out["lm_head/kernel"] = _t(sd["lm_head.weight"])
    out["model/final_norm/scale"] = sd["model.norm.weight"]
    i = 0
    while f"model.layers.{i}.input_layernorm.weight" in sd:
        q = f"model.layers.{i}."
        b = f"model/layer_{i}/"
        out[b + "input_norm/scale"] = sd[q + "input_layernorm.weight"]
        out[b + "post_attn_norm/scale"] = sd[
            q + "post_attention_layernorm.weight"]
        for proj in ["q_proj", "k_proj", "v_proj", "o_proj"]:
            out[b + f"attn/{proj}/kernel"] = _t(
                sd[q + f"self_attn.{proj}.weight"])
        for proj in ["gate_proj", "up_proj", "down_proj"]:
            out[b + f"mlp/{proj}/kernel"] = _t(sd[q + f"mlp.{proj}.weight"])
        i += 1
    return out


def port_vgg16(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """torchvision vgg16 features → VGG16Features conv paths."""
    out: Dict[str, np.ndarray] = {}
    conv_idx = 0
    for k in sorted(sd, key=lambda s: [int(t) if t.isdigit() else t
                                       for t in s.split(".")]):
        if k.startswith("features.") and k.endswith(".weight") \
                and sd[k].ndim == 4:
            out[f"conv_{conv_idx}/kernel"] = np.transpose(
                sd[k], (2, 3, 1, 0))
            out[f"conv_{conv_idx}/bias"] = sd[k.replace(".weight", ".bias")]
            conv_idx += 1
    return out


def port_lpips_lins(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """taming LPIPS lin heads (lin0..lin4.model.1.weight 1×1 convs)."""
    out = {}
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                out[f"lin_{i}/kernel"] = np.transpose(sd[key], (2, 3, 1, 0))
    return out


def port_qformer_bert(sd: Dict[str, np.ndarray],
                      num_layers: int = 6,
                      cross_attention_freq: int = 2
                      ) -> Dict[str, np.ndarray]:
    """HF bert-base → QFormer paths (the stripped executed subset only:
    self-attn, query FFN re-using BERT's FFN init, embedding LayerNorm).
    Cross-attention weights have no BERT counterpart (fresh in BLIP-2 too).
    """
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""
    out: Dict[str, np.ndarray] = {}
    out["embed_norm/scale"] = sd[pre + "embeddings.LayerNorm.weight"]
    out["embed_norm/bias"] = sd[pre + "embeddings.LayerNorm.bias"]
    m = {
        "self_attn/query": "attention.self.query",
        "self_attn/key": "attention.self.key",
        "self_attn/value": "attention.self.value",
        "self_attn/out": "attention.output.dense",
        "ffn_in": "intermediate.dense",
        "ffn_out": "output.dense",
    }
    for i in range(num_layers):
        q = f"{pre}encoder.layer.{i}."
        b = f"layer_{i}/"
        for ours, theirs in m.items():
            out[b + ours + "/kernel"] = _t(sd[q + theirs + ".weight"])
            out[b + ours + "/bias"] = sd[q + theirs + ".bias"]
        out[b + "self_attn/out_norm/scale"] = sd[
            q + "attention.output.LayerNorm.weight"]
        out[b + "self_attn/out_norm/bias"] = sd[
            q + "attention.output.LayerNorm.bias"]
        out[b + "ffn_norm/scale"] = sd[q + "output.LayerNorm.weight"]
        out[b + "ffn_norm/bias"] = sd[q + "output.LayerNorm.bias"]
    return out


PORTERS = {
    "siglip": port_siglip_vision,
    "llama": port_llama,
    "vgg16": port_vgg16,
    "lpips_lins": port_lpips_lins,
    "qformer": port_qformer_bert,
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] not in PORTERS:
        print(__doc__)
        sys.exit(1)
    kind, src, dst = argv
    sd = load_state_dict(src)
    out = PORTERS[kind](sd)
    np.savez(dst, **out)
    print(f"ported {len(out)} arrays → {dst}")
    for k in list(out)[:5]:
        print(" ", k, out[k].shape)


if __name__ == "__main__":
    main()
