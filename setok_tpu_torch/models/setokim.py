"""Setokim MLLM for serving: LLaMA trunk + SeTok vision modules.

The counterpart of the serving half of `setok_tpu/models/setokim.py`:
`tokenize`, `encode_images`, the static multimodal splice
(`prepare_multimodal`), `prefill`, `prefill_text` and `decode_step`, with
the same sub-module names (`llama`, `vision_tower`, `mm_in_projector`,
`vision_generator`, `mm_out_projector`) as the flax tree.

The splice needs no dynamic shapes: the collator reserves `k_max` slots
holding `IMAGE_TOKEN_INDEX` per image; those slots take the projected
concept tokens in order, slots beyond an image's cluster count are holes
(masked out of attention), and positions are the running count of valid
slots.

The cache is written in place (models/llama.py); `cache_valid` is returned
as a new tensor, as the JAX package returns it. Not ported here: the
training forward, the diffusion head and `sample_image_tokens` (ROADMAP.md,
Queue A).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from setok_tpu_torch.config import SetokimConfig
from setok_tpu_torch.constants import IMAGE_TOKEN_INDEX
from setok_tpu_torch.models.detokenizer import SetokDeTokenizer
from setok_tpu_torch.models.llama import (KVCache, LlamaForCausalLM,
                                          init_cache, make_attention_mask)
from setok_tpu_torch.models.projector import build_projector
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.utils.device import resolve_device


class Setokim(nn.Module):
    def __init__(self, cfg: SetokimConfig, target_token_id: int = 3,
                 pad_token_id: int = 0, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 cache_kernel: bool = False, use_flash: bool = False,
                 ring_mesh: Any = None, remat: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.target_token_id = target_token_id
        self.pad_token_id = pad_token_id
        self.dtype = dtype
        self.llama = LlamaForCausalLM(
            cfg.llama, dtype=dtype, weight_bits=weight_bits,
            quant_group=quant_group, cache_kernel=cache_kernel,
            use_flash=use_flash, ring_mesh=ring_mesh, remat=remat,
            device=device)
        self.vision_tower = SetokTokenizer(cfg.tokenizer, dtype=dtype,
                                           device=device)
        self.mm_in_projector = build_projector(
            cfg.mm_in_projector_type, cfg.tokenizer.token_feat_dim,
            cfg.llama.hidden_size, dtype=dtype, device=device)
        self.vision_generator = SetokDeTokenizer(cfg.detokenizer, dtype=dtype,
                                                 device=device)
        self.mm_out_projector = build_projector(
            cfg.mm_out_projector_type, cfg.llama.hidden_size,
            cfg.diffloss.z_channels, dtype=dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "the training forward (CE + diffusion loss) is not ported: "
            "ROADMAP.md, Queue A (stage-2 training)")

    # ------------------------------------------------------------------
    def tokenize(self, images):
        """Concept tokens of (N, H, W, 3) images (SeTok encode)."""
        return self.vision_tower(images)

    @torch.inference_mode()
    def encode_images(self, images):
        """images (N, H, W, 3) → (N, k_max, llama hidden), valid (N, k_max)."""
        tok = self.vision_tower(images)
        return self.mm_in_projector(tok.tokens), tok.token_valid

    @torch.inference_mode()
    def prepare_multimodal(self, input_ids, images):
        """Static splice → (embeds, valid, positions).

        input_ids: (B, L) with IMAGE_TOKEN_INDEX at the reserved slots;
        images: (B, H, W, 3), one per row, or (B, M, H, W, 3), the slots
        taking the images in order."""
        b, _ = input_ids.shape
        k_max = self.cfg.tokenizer.k_max
        if images.dim() == 5:
            m = images.shape[1]
            f, v = self.encode_images(images.reshape(b * m, *images.shape[2:]))
            img_feats, img_valid = f.reshape(b, m * k_max, -1), v.reshape(
                b, m * k_max)
        else:
            img_feats, img_valid = self.encode_images(images)
        n_slots = img_valid.shape[1]
        is_image = input_ids == IMAGE_TOKEN_INDEX
        slot_rank = (torch.cumsum(is_image.to(torch.int64), dim=1) - 1).clamp(
            0, n_slots - 1)
        text_emb = self.llama.embed(input_ids)
        gathered = torch.gather(
            img_feats.to(text_emb.dtype), 1,
            slot_rank[..., None].expand(-1, -1, img_feats.shape[-1]))
        embeds = torch.where(is_image[..., None], gathered, text_emb)
        valid = torch.where(is_image, torch.gather(img_valid, 1, slot_rank),
                            input_ids != self.pad_token_id)
        positions = torch.cumsum(valid.to(torch.int32), dim=1) - 1
        return embeds, valid, positions

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, input_ids, images, max_len: int, *,
                cache_dtype=torch.float32):
        """The spliced prompt through the trunk into a new cache →
        (logits_last, hidden_last, cache, cache_valid, positions)."""
        embeds, valid, positions = self.prepare_multimodal(input_ids, images)
        return self._prefill_trunk(embeds, valid, positions, max_len,
                                   cache_dtype)

    @torch.inference_mode()
    def prefill_text(self, input_ids, max_len: int, *,
                     cache_dtype=torch.float32):
        """`prefill` without the vision tower, for text-only prompts."""
        valid = input_ids != self.pad_token_id
        positions = torch.cumsum(valid.to(torch.int32), dim=1) - 1
        return self._prefill_trunk(self.llama.embed(input_ids), valid,
                                   positions, max_len, cache_dtype)

    def _prefill_trunk(self, embeds, valid, positions, max_len, cache_dtype):
        b, l = valid.shape
        cache = init_cache(self.cfg.llama, b, max_len, dtype=cache_dtype,
                           device=embeds.device)
        cache_valid = torch.zeros((b, max_len), dtype=torch.bool,
                                  device=valid.device)
        cache_valid[:, :l] = valid
        mask = make_attention_mask(valid, positions, cache_valid=cache_valid)
        hidden, cache = self.llama.model(embeds, mask, positions, cache)
        # the last valid slot (holes make it differ from sum(valid) - 1)
        last = l - 1 - torch.argmax(valid.flip(1).to(torch.int32), dim=1)
        hidden_last = hidden[torch.arange(b, device=hidden.device), last]
        return (self.llama.logits(hidden_last), hidden_last, cache,
                cache_valid, positions)

    @torch.inference_mode()
    def decode_step(self, token_ids, cache: KVCache, cache_valid,
                    next_position):
        """One decode step: token_ids (B, 1) → (logits, hidden, cache,
        cache_valid). With a per-row (B,) `cache.length`, a row whose
        column lies past the cache marks nothing (the JAX scatter's
        `mode="drop"`), while its K/V write clamps to the last column."""
        b = token_ids.shape[0]
        s = cache_valid.shape[1]
        cache_valid = cache_valid.clone()
        if isinstance(cache.length, torch.Tensor):
            rows = torch.arange(b, device=cache_valid.device)
            cols = cache.length.clamp(max=s - 1)
            cache_valid[rows, cols] = cache_valid[rows, cols] | (
                cache.length < s)
        else:
            cache_valid[:, min(max(cache.length, 0), s - 1)] = True
        valid = torch.ones((b, 1), dtype=torch.bool, device=token_ids.device)
        positions = next_position[:, None]
        mask = make_attention_mask(valid, positions, cache_valid=cache_valid)
        hidden, cache = self.llama.model(self.llama.embed(token_ids), mask,
                                         positions, cache)
        return (self.llama.logits(hidden)[:, 0], hidden[:, 0], cache,
                cache_valid)
