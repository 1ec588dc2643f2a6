"""Setokim MLLM: LLaMA trunk + SeTok vision modules + the MAR head.

The counterpart of `setok_tpu/models/setokim.py`: `tokenize`,
`encode_images`, the static multimodal splice (`prepare_multimodal`), the
training forward (`forward`: CE in the hole layout plus the diffusion
branch), `prefill`, `prefill_text`, `decode_step`, and the serving
features' `prefill_text_chunk` (chunked prefill, the prefix cache) and
`verify_step` (speculative decoding), with the same
sub-module names (`llama`, `vision_tower`, `mm_in_projector`,
`vision_generator`, `mm_out_projector`, `diffloss`) as the flax tree.

The splice needs no dynamic shapes: the collator reserves `k_max` slots
holding `IMAGE_TOKEN_INDEX` per image; those slots take the projected
concept tokens in order, slots beyond an image's cluster count are holes
(masked out of attention), and positions are the running count of valid
slots.

The training forward's randomness is split out: `draw_forward` makes the
draws (the tower's dropout generator, and the diffusion branch's orders,
mask rate, timesteps and noise) from a `torch.Generator`, and `forward`
computes on them, so that the JAX package's draws can be replayed. The
detokenizer is frozen (label 'frozen' in the trainers) and runs under
`torch.no_grad()` here, as do `tokenize` and the diffusion branch's gold
tokens (the JAX package's stop-gradient). The splice's tower tokens
(`encode_images`) carry a graph where the tower's parameters require one
(`unfreeze_mm_vision_tower`); its backbone stays frozen
(`freeze_backbone=True`, as the JAX package builds it), and a frozen
tower's tokens enter the trainable projector as constants. Parameters live
in `param_dtype` (float32, or bf16 as the JAX trainers' `param_dtype`
stores them), passed to every submodule; `dtype` is the compute type.

The cache is written in place (models/llama.py); `cache_valid` is returned
as a new tensor, as the JAX package returns it. The serving entry points
run under `torch.inference_mode()`.

Image generation: `sample_image_tokens` is the MaskGIT/MAR loop (a cosine
mask schedule over a random order per row; each iteration samples every
token with the diffusion head conditioned on mm_out_projector(hidden) and
keeps those it unmasks), and `render_image` renders the concept tokens
with the float detokenizer. Its draws (the orders, and each iteration's
sampler draws) come in an `ImageDraws`, from `draw_image` or replayed.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from setok_tpu_torch.config import SetokimConfig
from setok_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from setok_tpu_torch.losses.diffloss import DiffLoss, SampleDraws
from setok_tpu_torch.models.detokenizer import SetokDeTokenizer
from setok_tpu_torch.models.llama import (KVCache, LlamaForCausalLM,
                                          init_cache, make_attention_mask)
from setok_tpu_torch.models.projector import build_projector
from setok_tpu_torch.parallel import comm
from setok_tpu_torch.models.tokenizer import SetokTokenizer
from setok_tpu_torch.utils.device import resolve_device


class SetokimOutput(NamedTuple):
    loss: torch.Tensor
    lm_loss: torch.Tensor
    diff_loss: torch.Tensor
    logits: torch.Tensor
    hidden: torch.Tensor
    valid: torch.Tensor


class DiffusionDraws(NamedTuple):
    """The diffusion branch's random inputs: `orders` (B, T) a permutation
    of 0..T-1 per row, `rate` the mask rate (a float32 scalar), `t` (N,)
    timesteps and `noise` (N, C), N = diffusion_batch_mul·B·T."""
    orders: torch.Tensor
    rate: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor


class ImageDraws(NamedTuple):
    """The draws of one `sample_image_tokens` over (B, T) tokens: `orders`
    (B, T), a permutation of 0..T-1 per row (the order in which tokens are
    unmasked), and `iteration(k)`, the `SampleDraws` of iteration k's
    sampler over all B·T rows (2·B·T under guidance)."""
    orders: torch.Tensor
    iteration: Callable[[int], SampleDraws]


class ForwardDraws(NamedTuple):
    """Everything random in one training forward: the tower's dropout
    generator (None: no dropout) and the diffusion draws (None: no
    diffusion loss)."""
    dropout: Optional[torch.Generator]
    diffusion: Optional[DiffusionDraws]


def splice_layout(input_ids: torch.Tensor, img_valid: torch.Tensor,
                  pad_token_id: int):
    """The static splice's layout → (is_image, slot_rank, valid, positions):
    the i-th image slot of a row takes concept token i (of the row's images
    in order), a slot past the image's cluster count is a hole, and
    positions count the valid slots."""
    is_image = input_ids == IMAGE_TOKEN_INDEX
    slot_rank = (torch.cumsum(is_image.to(torch.int64), dim=1) - 1).clamp(
        0, img_valid.shape[1] - 1)
    valid = torch.where(is_image, torch.gather(img_valid, 1, slot_rank),
                        input_ids != pad_token_id)
    positions = torch.cumsum(valid.to(torch.int32), dim=1) - 1
    return is_image, slot_rank, valid, positions


def mask_by_order(mask_len: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """(B,) mask_len + (B, S) orders → (B, S) bool: True for the first
    mask_len entries of each order."""
    ranks = torch.argsort(orders, dim=-1)
    return ranks < mask_len[:, None]


def truncated_normal(lower: float, upper: float, generator: torch.Generator,
                     device) -> torch.Tensor:
    """One float32 draw of N(0, 1) truncated to (lower, upper), by the
    inverse CDF, as `jax.random.truncated_normal` draws it."""
    sqrt2 = math.sqrt(2.0)
    a, b = math.erf(lower / sqrt2), math.erf(upper / sqrt2)
    u = a + (b - a) * torch.rand((), generator=generator, device=device)
    x = sqrt2 * torch.erfinv(u)
    return x.clamp(math.nextafter(lower, math.inf),
                   math.nextafter(upper, -math.inf))


class Setokim(nn.Module):
    def __init__(self, cfg: SetokimConfig, target_token_id: int = 3,
                 pad_token_id: int = 0, *, dtype=torch.float32,
                 weight_bits: int = 16, quant_group: int = 0,
                 cache_kernel: bool = False, use_flash: bool = False,
                 ring_mesh: Any = None, remat: bool = False,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.target_token_id = target_token_id
        self.pad_token_id = pad_token_id
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.llama = LlamaForCausalLM(
            cfg.llama, weight_bits=weight_bits, quant_group=quant_group,
            cache_kernel=cache_kernel, use_flash=use_flash,
            ring_mesh=ring_mesh, remat=remat, **kw)
        self.vision_tower = SetokTokenizer(cfg.tokenizer, **kw)
        self.mm_in_projector = build_projector(
            cfg.mm_in_projector_type, cfg.tokenizer.token_feat_dim,
            cfg.llama.hidden_size, **kw)
        self.vision_generator = SetokDeTokenizer(cfg.detokenizer, **kw)
        self.mm_out_projector = build_projector(
            cfg.mm_out_projector_type, cfg.llama.hidden_size,
            cfg.diffloss.z_channels, **kw)
        self.diffloss = DiffLoss(cfg.diffloss, **kw)
        # data parallelism: the process group over which the losses'
        # denominators sum (each rank's loss is then its share of the
        # global batch's), or None
        self.count_group = None

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    # ------------------------------------------------------------------
    def tokenize(self, images, generator=None):
        """Concept tokens of (N, H, W, 3) images (SeTok encode)."""
        with torch.no_grad():
            return self.vision_tower(images, generator=generator)

    def detokenize(self, tokens, token_valid=None):
        """Concept tokens → pixels through the frozen vision generator."""
        with torch.no_grad():
            return self.vision_generator(tokens, token_valid)

    def encode_images(self, images, generator=None):
        """images (N, H, W, 3) → (N, k_max, llama hidden), valid (N, k_max).
        The tower runs with a graph where its parameters require one (a
        trainer's `unfreeze_mm_vision_tower`); its backbone and clustering
        never carry one (models/tokenizer.py). A frozen tower's tokens
        enter the projector as constants."""
        tok = self.vision_tower(images, generator=generator)
        return self.mm_in_projector(tok.tokens), tok.token_valid

    def prepare_multimodal(self, input_ids, images, generator=None):
        """Static splice → (embeds, valid, positions).

        input_ids: (B, L) with IMAGE_TOKEN_INDEX at the reserved slots;
        images: (B, H, W, 3), one per row, or (B, M, H, W, 3), the slots
        taking the images in order; `generator` runs the tower's dropout."""
        b, _ = input_ids.shape
        k_max = self.cfg.tokenizer.k_max
        if images.dim() == 5:
            m = images.shape[1]
            f, v = self.encode_images(images.reshape(b * m, *images.shape[2:]),
                                      generator)
            img_feats, img_valid = f.reshape(b, m * k_max, -1), v.reshape(
                b, m * k_max)
        else:
            img_feats, img_valid = self.encode_images(images, generator)
        is_image, slot_rank, valid, positions = splice_layout(
            input_ids, img_valid, self.pad_token_id)
        text_emb = self.llama.embed(input_ids)
        gathered = torch.gather(
            img_feats.to(text_emb.dtype), 1,
            slot_rank[..., None].expand(-1, -1, img_feats.shape[-1]))
        embeds = torch.where(is_image[..., None], gathered, text_emb)
        return embeds, valid, positions

    # ------------------------------------------------------------------
    def draw_forward(self, batch_size: int,
                     generator: torch.Generator) -> ForwardDraws:
        """The draws of one training forward from `generator`, in this
        order: the diffusion orders, the mask rate, the timesteps and the
        noise; the tower's dropout then draws from `generator` itself."""
        cfg, dev = self.cfg, self.device
        b, tn = batch_size, cfg.target_num
        orders = torch.argsort(torch.rand((b, tn), generator=generator,
                                          device=dev), dim=1)
        mr = cfg.diffloss.mask_ratio_min
        rate = truncated_normal((mr - 1.0) / 0.25, 0.0, generator, dev)
        n = cfg.diffloss.diffusion_batch_mul * b * tn
        t, noise = self.diffloss.draw(n, generator, dev)
        return ForwardDraws(generator, DiffusionDraws(orders, rate * 0.25 + 1.0,
                                                      t, noise))

    def forward(self, input_ids, images=None, labels=None, gen_images=None,
                draws: Optional[ForwardDraws] = None) -> SetokimOutput:
        """The training forward: CE in the hole layout, plus the diffusion
        loss when gold images, labels and diffusion draws are given.

        labels: (B, L) ids with IGNORE_INDEX masking; `<target>` slots
        carry target_token_id (the diffusion branch gathers them; CE
        ignores them). gen_images: (B, H, W, 3) gold images."""
        gen = None if draws is None else draws.dropout
        if images is not None:
            embeds, valid, positions = self.prepare_multimodal(
                input_ids, images, gen)
        else:
            valid = input_ids != self.pad_token_id
            positions = torch.cumsum(valid.to(torch.int32), dim=1) - 1
            embeds = self.llama.embed(input_ids)
        if self.llama.ring_mesh is not None:
            # ring attention derives causality from positions/valid per
            # sequence slice: no (B, 1, L, L) global mask exists
            hidden = self.llama.ring_forward(embeds, positions, valid)
        else:
            mask = make_attention_mask(valid, positions)
            hidden, _ = self.llama.model(embeds, mask, positions)
        logits = self.llama.logits(hidden)

        zero = hidden.new_zeros((), dtype=torch.float32)
        lm_loss = zero
        if labels is not None:
            lm_loss = self._lm_loss(logits, labels, valid)
        diff_loss = zero
        if (gen_images is not None and labels is not None
                and draws is not None and draws.diffusion is not None):
            diff_loss = self._diffusion_branch(hidden, labels, gen_images,
                                               draws.diffusion)
        return SetokimOutput(loss=lm_loss + diff_loss, lm_loss=lm_loss,
                             diff_loss=diff_loss, logits=logits,
                             hidden=hidden, valid=valid)

    def _lm_loss(self, logits, labels, valid):
        """Shifted CE where the predictor of token j is the last valid slot
        before j (a hole before a text token contributes nothing). The
        predicting logits are gathered before the float32 log-softmax, so
        the (B, L, V) log-probabilities exist once."""
        ce_labels = torch.where(labels == self.target_token_id,
                                IGNORE_INDEX, labels)
        l_idx = torch.arange(labels.shape[1], device=labels.device)
        last_valid = torch.cummax(torch.where(valid, l_idx[None, :], -1),
                                  dim=1).values
        pred_idx = last_valid[:, :-1]
        shift_labels = ce_labels[:, 1:]
        shift_valid = (valid[:, 1:] & (shift_labels != IGNORE_INDEX)
                       & (pred_idx >= 0))
        pred_logits = torch.gather(
            logits, 1, pred_idx.clamp_min(0)[..., None].expand(
                -1, -1, logits.shape[-1]))
        logp = torch.log_softmax(pred_logits.float(), dim=-1)
        picked = torch.gather(logp, 2, shift_labels.clamp_min(0)[..., None])
        denom = comm.all_reduce_(shift_valid.sum(), self.count_group)
        return -(picked[..., 0] * shift_valid).sum() / denom.clamp_min(1)

    def _diffusion_branch(self, hidden, labels, gen_images,
                          draws: DiffusionDraws):
        """MAR loss over the `<target>` slots: their hidden states through
        mm_out_projector condition the denoiser of the gold image's concept
        tokens (the frozen tower, no dropout); a truncated-normal share of
        the tokens, in a random order per row, is masked in."""
        cfg = self.cfg
        b = hidden.shape[0]
        tn = cfg.target_num
        is_target = labels == self.target_token_id
        has_target = is_target.any(dim=1)
        order = torch.sort((~is_target).to(torch.int8), dim=1,
                           stable=True).indices
        slots = order[:, :tn]
        z = torch.gather(hidden, 1, slots[..., None].expand(
            -1, -1, hidden.shape[-1]))
        z = self.mm_out_projector(z)
        with torch.no_grad():
            gold = self.vision_tower(gen_images)
        target, target_valid = gold.tokens, gold.token_valid
        num_masked = torch.ceil(tn * draws.rate).to(torch.int64)
        diff_mask = mask_by_order(num_masked.expand(b), draws.orders)
        diff_mask = (diff_mask & target_valid
                     & has_target[:, None]).to(torch.float32)
        mul = cfg.diffloss.diffusion_batch_mul
        flat_t = target.reshape(b * tn, -1).repeat(mul, 1)
        flat_z = z.reshape(b * tn, -1).repeat(mul, 1)
        flat_m = diff_mask.reshape(-1).repeat(mul)
        return self.diffloss(flat_t, flat_z, flat_m, t=draws.t,
                             noise=draws.noise, count_group=self.count_group)

    def init_all(self, input_ids, images, labels, gen_images,
                 draws: Optional[ForwardDraws] = None) -> SetokimOutput:
        """The JAX package's init entry: the training forward, then the
        detokenizer on a dummy (the one submodule the forward skips). Here
        every parameter exists at construction; this runs each once."""
        out = self(input_ids, images, labels, gen_images, draws)
        with torch.no_grad():
            self.vision_generator(torch.zeros(
                (1, self.cfg.tokenizer.k_max,
                 self.cfg.detokenizer.token_feat_dim), device=self.device))
        return out

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
                           device=embeds.device,
                           kv_heads=self.llama.kv_heads)
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
        valid = torch.ones(token_ids.shape, dtype=torch.bool,
                           device=token_ids.device)
        cache_valid = mark_columns(cache_valid, cache.length, valid)
        positions = next_position[:, None]
        mask = make_attention_mask(valid, positions, cache_valid=cache_valid)
        hidden, cache = self.llama.model(self.llama.embed(token_ids), mask,
                                         positions, cache)
        return (self.llama.logits(hidden)[:, 0], hidden[:, 0], cache,
                cache_valid)

    @torch.inference_mode()
    def prefill_text_chunk(self, token_ids, cache: KVCache, cache_valid,
                           pos_offset):
        """One chunk of a chunked text-only prefill: token_ids (B, C) →
        (logits (B, C, V), hidden, cache, cache_valid).

        Prompts are left-aligned, so feeding them in chunks of C gives the
        single-shot `prefill_text`'s cache: the chunk is appended at
        [cache.length, cache.length + C) with its pads marked invalid, and
        positions continue from `pos_offset` (B,), the count of valid
        tokens in the earlier chunks."""
        chunk_valid = token_ids != self.pad_token_id
        cache_valid = mark_columns(cache_valid, cache.length, chunk_valid)
        positions = (pos_offset[:, None]
                     + torch.cumsum(chunk_valid.to(torch.int32), dim=1)
                     - 1).clamp_min(0)
        mask = make_attention_mask(chunk_valid, positions,
                                   cache_valid=cache_valid)
        hidden, cache = self.llama.model(self.llama.embed(token_ids), mask,
                                         positions, cache)
        return self.llama.logits(hidden), hidden, cache, cache_valid

    @torch.inference_mode()
    def verify_step(self, token_ids, cache: KVCache, cache_valid,
                    next_position):
        """The speculative verify: token_ids (B, T) = [current token, T - 1
        drafts] → (logits (B, T, V), hidden (B, T, H), cache, cache_valid),
        every position scored in one forward (causal within the chunk,
        appended at [length, length + T), positions next_position + 0..T-1).
        The caller rewinds `length` and the validity of the rejected
        drafts (serve/engine.py)."""
        valid = torch.ones(token_ids.shape, dtype=torch.bool,
                           device=token_ids.device)
        cache_valid = mark_columns(cache_valid, cache.length, valid)
        positions = next_position[:, None] + torch.arange(
            token_ids.shape[1], device=token_ids.device, dtype=torch.int32)
        mask = make_attention_mask(valid, positions, cache_valid=cache_valid)
        hidden, cache = self.llama.model(self.llama.embed(token_ids), mask,
                                         positions, cache)
        return self.llama.logits(hidden), hidden, cache, cache_valid

    # ------------------------------------------------------------------
    def draw_image(self, batch_size: int, seq_len: int, cfg_scale: float,
                   generator: Optional[torch.Generator]) -> ImageDraws:
        """The draws of one `sample_image_tokens` from `generator`: the
        orders now, each iteration's sampler draws when it runs."""
        dev = self.device
        orders = torch.argsort(torch.rand((batch_size, seq_len),
                                          generator=generator, device=dev),
                               dim=1)
        use_cfg = cfg_scale != 1.0
        n = batch_size * seq_len * (2 if use_cfg else 1)
        return ImageDraws(orders, lambda k: self.diffloss.draw_sample(
            n, use_cfg, generator, dev))

    @torch.inference_mode()
    def sample_image_tokens(self, cond, generator=None, num_iter: int = 16,
                            cfg_scale: float = 1.0, temperature: float = 1.0,
                            *, draws: Optional[ImageDraws] = None):
        """MaskGIT/MAR decoding of concept tokens: cond (B, T, H_llm) hidden
        states of a generation span → (B, T, token_feat_dim).

        Iteration k keeps masked the first floor(T·cos(π/2·(k+1)/num_iter))
        tokens of each row's order (at least 1, at most one fewer than are
        masked), and the last iteration unmasks the rest. Each iteration
        samples all B·T tokens and writes those it unmasks. Under guidance
        the scale follows Muse's linear schedule, read from row 0's mask
        length. Without `draws`, they are drawn from `generator`."""
        b, seq_len, _ = cond.shape
        if draws is None:
            draws = self.draw_image(b, seq_len, cfg_scale, generator)
        use_cfg = cfg_scale != 1.0
        flat_z = self.mm_out_projector(cond).reshape(b * seq_len, -1)
        if use_cfg:
            flat_z = torch.cat([flat_z, torch.zeros_like(flat_z)], dim=0)
        c_dim = self.cfg.diffloss.target_channels
        tokens = torch.zeros((b, seq_len, c_dim), device=cond.device)
        mask = torch.ones((b, seq_len), dtype=torch.bool, device=cond.device)
        for step in range(num_iter):
            mask_next, to_pred, mask_len = mask_schedule(
                mask, draws.orders, step, num_iter)
            mask = mask_next
            cfg_iter = 1.0
            if use_cfg:
                cfg_iter = 1.0 + (cfg_scale - 1.0) * (
                    seq_len - mask_len[0]) / seq_len
            sampled = self.diffloss.sample(flat_z, temperature, cfg_iter,
                                           use_cfg, draws.iteration(step))
            sampled = sampled[: b * seq_len].reshape(b, seq_len, c_dim)
            tokens = torch.where(to_pred[..., None], sampled, tokens)
        return tokens

    @torch.inference_mode()
    def render_image(self, concept_tokens, token_valid=None):
        """Concept tokens → pixels through the float detokenizer."""
        return self.vision_generator(concept_tokens, token_valid)


def mark_columns(cache_valid: torch.Tensor, start,
                 values: torch.Tensor) -> torch.Tensor:
    """A copy of the (B, S) validity with `values` (B, T) written at
    columns [start, start + T). `start` an int: the block clamps to fit,
    as `dynamic_update_slice` does (and as the K/V write does). `start` a
    (B,) tensor: each column past S is dropped on its own (the JAX
    scatter's `mode="drop"`), while the K/V write clamps the whole block
    to S - T; the writes go to a buffer T columns wider, cut after."""
    b, s = cache_valid.shape
    t = values.shape[1]
    if not isinstance(start, torch.Tensor):
        s0 = min(max(int(start), 0), s - t)
        out = cache_valid.clone()
        out[:, s0:s0 + t] = values
        return out
    wide = torch.cat([cache_valid, cache_valid.new_zeros((b, t))], dim=1)
    cols = (start[:, None].long()
            + torch.arange(t, device=start.device)).clamp(max=s + t - 1)
    wide[torch.arange(b, device=start.device)[:, None], cols] = values
    return wide[:, :s].contiguous()


def mask_schedule(mask: torch.Tensor, orders: torch.Tensor, step: int,
                  num_iter: int):
    """One iteration of the MaskGIT cosine schedule → (the mask after it,
    the tokens it unmasks, the float32 (B,) mask lengths). The cosine and
    the floor are float32 on the host, so every device takes the same
    lengths."""
    seq_len = mask.shape[1]
    ratio = np.cos(np.float32(math.pi / 2.0 * (step + 1) / num_iter))
    floor = float(np.floor(np.float32(seq_len) * ratio))
    mask_len = (mask.sum(dim=-1).to(torch.float32) - 1.0).clamp(
        max=floor).clamp(min=1.0)
    mask_next = mask_by_order(mask_len.to(torch.int64), orders)
    to_pred = mask if step >= num_iter - 1 else mask ^ mask_next
    return mask_next, to_pred, mask_len
