"""Stage-1 SeTok training: reconstruction, PatchGAN and contrastive terms.

The counterpart of `setok_tpu/train/stage1.py` on one card. One
`train_step` runs a generator update, then a discriminator update, each
with its own optimizer:

  * generator: SeTok `tokenize` → `detokenize` (dropout from the step's
    `torch.Generator`); rec = rec_l1_weight·L1 (+ lpips_weight·LPIPS);
    g = −E[D(recon)] through the discriminator as it was before the step;
    the adaptive weight ‖∇rec‖ / (‖∇g‖ + 1e-4), both gradients with
    respect to the pixel-head weight alone, on hidden.detach() @ Wᵀ + b;
    the factor `adopt_weight(factor, step, disc_start, warm_up_end)`;
    total = rec + d_weight·factor·g, plus contrastive_weight times the
    contrastive loss of the valid tokens' mean against `text_emb` (or the
    text tower's embedding of `input_ids_for_contrastive`);
  * discriminator: adopt_weight(factor, step, disc_start) (no warm-up)
    times the hinge (or vanilla) loss of D(gold) and D(recon.detach());
  * optimizers: the generator's AdamW (eps 1e-8, the config's betas and
    weight decay) at `warmup_cosine` of its update count, with warmup =
    min(warmup_steps, total_steps - 1), so the first update runs at lr 0;
    the discriminator's Adam at the constant `disc_learning_rate`; each
    clipped to `max_grad_norm` by its own global norm (optax's rule);
  * `grad_accum_steps` micro-batches per update, as `optax.MultiSteps`:
    the running mean of the gradients, both optimizers in lockstep.
    `step` counts micro-batches; the adversarial factors read it.

The metrics are the JAX step's (l1_loss, lpips_loss, g_loss, d_weight,
disc_factor, rec_loss, num_clusters, total_loss, d_loss, logits_real,
logits_fake, contrastive_loss[, multi_label_loss]) and the pre-clip
`grad_norm` of the micro-batch's generator gradients.

Frozen parameters: the JAX optimizer walks the whole generator tree, the
frozen ViT included, whose gradients are zero; with weight decay 0, AdamW
leaves it unchanged. Here the frozen parameters (the tokenizer's
`frozen_parameters`, `requires_grad` off) are in no optimizer: the same
result, bit for bit. A weight decay above 0 would shrink the JAX
package's frozen backbone; the port refuses it rather than copy that.
The LPIPS net is frozen too. `offload_optimizer` and `optim_bits=8` are
not ported (`NotImplementedError`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from setok_tpu_torch.config import (ContrastiveLossConfig, DetokenizerConfig,
                                    GANLossConfig, TokenizerConfig,
                                    TrainConfig)
from setok_tpu_torch.losses.contrastive import ContrastiveLoss
from setok_tpu_torch.losses.gan import (NLayerDiscriminator, adaptive_weight,
                                        adopt_weight, discriminator_loss,
                                        generator_loss)
from setok_tpu_torch.losses.lpips import LPIPS
from setok_tpu_torch.losses.mse import l1_loss
from setok_tpu_torch.models.detokenizer import unpatchify
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.models.text_encoder import TextEncoder
from setok_tpu_torch.train.stage2 import (accumulate, global_norm,
                                          optimizer_step, warmup_cosine)
from setok_tpu_torch.utils import metrics as quality
from setok_tpu_torch.utils.device import resolve_device
from setok_tpu_torch.utils.init import init_random_

NOT_PORTED = {
    "offload_optimizer": "Adam moments in host memory (a TPU memory-space "
                         "feature of the JAX package): not ported",
    "optim_bits": "8-bit AdamW moments (train/opt8.py): ROADMAP.md, Queue A "
                  "(stage-2 options)",
}
# the discriminator's convolution kernels: flax normal(0.02)
DISC_CONV_STD = 0.02


@dataclasses.dataclass(eq=False)
class Stage1Trainer:
    tokenizer_cfg: TokenizerConfig
    detokenizer_cfg: DetokenizerConfig
    gan_cfg: GANLossConfig = dataclasses.field(default_factory=GANLossConfig)
    contrastive_cfg: ContrastiveLossConfig = dataclasses.field(
        default_factory=ContrastiveLossConfig)
    train_cfg: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    use_lpips: bool = False
    use_text_encoder: bool = False
    offload_optimizer: bool = False
    optim_bits: int = 32
    device: Any = None

    def __post_init__(self):
        for name, on in (("offload_optimizer", self.offload_optimizer),
                         ("optim_bits", self.optim_bits != 32)):
            if on:
                raise NotImplementedError(f"{name}: {NOT_PORTED[name]}")
        tc = self.train_cfg
        if tc.param_dtype != "float32":
            raise ValueError(f"param_dtype {tc.param_dtype}: the port keeps "
                             "float32 parameters")
        if tc.weight_decay != 0:
            raise ValueError("weight_decay must be 0: the JAX trainer's "
                             "AdamW would decay the frozen backbone too")
        dev = self.device = resolve_device(self.device)
        dtype = getattr(torch, tc.compute_dtype)
        self.model = SeTok(self.tokenizer_cfg, self.detokenizer_cfg,
                           dtype=dtype, device=dev)
        self.disc = NLayerDiscriminator(
            n_layers=self.gan_cfg.disc_num_layers,
            in_channels=self.gan_cfg.disc_in_channels, dtype=dtype,
            device=dev)
        self.contrastive = ContrastiveLoss(self.contrastive_cfg, device=dev)
        self.lpips = LPIPS(device=dev) if self.use_lpips else None
        self.text_encoder = (TextEncoder(
            embed_dim=self.tokenizer_cfg.token_feat_dim, device=dev)
            if self.use_text_encoder else None)
        self.warmup = min(tc.warmup_steps, max(tc.total_steps - 1, 0))
        self.gen_opt: Optional[torch.optim.Optimizer] = None

    # ------------------------------------------------------------------
    def init_weights_(self, seed: int = 0) -> None:
        """Random weights from `seed` for every module (the discriminator's
        kernels N(0, 0.02²), as its flax initializer draws them)."""
        init_random_(self.model, seed)
        init_random_(self.disc, seed + 1, conv_std=DISC_CONV_STD)
        init_random_(self.contrastive, seed + 2)
        if self.lpips is not None:
            init_random_(self.lpips, seed + 3)
        if self.text_encoder is not None:
            init_random_(self.text_encoder, seed + 4)

    def init_state(self) -> None:
        """The frozen flags, both optimizers and the step counters. The
        weights are the caller's (`init_weights_` or from_flax)."""
        tc = self.train_cfg
        for p in self.model.parameters():
            p.requires_grad_(True)
        for p in self.model.tokenizer.frozen_parameters():
            p.requires_grad_(False)
        if self.lpips is not None:
            self.lpips.requires_grad_(False)
        gen = [p for p in self.model.parameters() if p.requires_grad]
        gen += list(self.contrastive.parameters())
        if self.text_encoder is not None:
            gen += list(self.text_encoder.parameters())
        self.gen_params = gen
        self.disc_params = list(self.disc.parameters())
        self.gen_opt = torch.optim.AdamW(
            gen, lr=0.0, betas=(tc.beta1, tc.beta2), eps=1e-8,
            weight_decay=tc.weight_decay)
        self.disc_opt = torch.optim.Adam(
            self.disc_params, lr=tc.disc_learning_rate,
            betas=(tc.beta1, tc.beta2), eps=1e-8)
        self.step = 0            # micro-batches
        self.updates = 0         # optimizer updates
        self._acc = None

    def lr(self) -> float:
        """The generator's learning rate at its next update."""
        tc = self.train_cfg
        return warmup_cosine(self.updates, tc.learning_rate, self.warmup,
                             tc.total_steps)

    # ------------------------------------------------------------------
    def _rec_terms(self, recon, gold):
        tc = self.train_cfg
        rec = l1_loss(recon, gold) * tc.rec_l1_weight
        lp = torch.zeros((), device=rec.device)
        if self.lpips is not None:
            lp = self.lpips(recon, gold) * tc.lpips_weight
        return rec + lp, {"l1_loss": rec, "lpips_loss": lp}

    def _adaptive_weight(self, hidden, gold) -> torch.Tensor:
        """‖∂rec/∂W‖ / (‖∂g/∂W‖ + 1e-4) for the pixel-head weight W: the
        head recomputed as hidden.detach() @ Wᵀ + b on a detached copy of W
        (in float32 over bf16 hidden, as JAX promotes), one graph, two
        `torch.autograd.grad` calls."""
        ph = self.model.detokenizer.pixel_head
        h = hidden.detach()
        w = ph.weight.detach().requires_grad_()
        dt = torch.promote_types(h.dtype, w.dtype)
        recon = unpatchify(F.linear(h.to(dt), w.to(dt),
                                    ph.bias.detach().to(dt)),
                           self.detokenizer_cfg.patch_size)
        rec, _ = self._rec_terms(recon, gold)
        grad_rec, = torch.autograd.grad(rec, w, retain_graph=True)
        grad_g, = torch.autograd.grad(generator_loss(self.disc(recon)), w)
        return adaptive_weight(grad_rec, grad_g, self.gan_cfg.weight)

    def _text_embedding(self, batch) -> Optional[torch.Tensor]:
        text = batch.get("text_emb")
        if (text is None and self.text_encoder is not None
                and "input_ids_for_contrastive" in batch):
            text = self.text_encoder(batch["input_ids_for_contrastive"])
        return text

    # ------------------------------------------------------------------
    def generator_terms(self, batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None):
        """The generator's total loss (with its graph), its metrics and the
        reconstruction, at the current step and discriminator."""
        gan, tc = self.gan_cfg, self.train_cfg
        images, gold = batch["comp_image"], batch["gen_image"]
        dev = gold.device
        out = self.model.tokenize(images, generator)
        det = self.model.detokenize(out.tokens, out.token_valid, generator)
        recon = det.image
        rec_loss, metrics = self._rec_terms(recon, gold)
        g_loss = generator_loss(self.disc(recon))
        d_weight = (self._adaptive_weight(det.hidden, gold)
                    if gan.use_adaptive_weight
                    else torch.tensor(gan.weight, device=dev))
        factor = adopt_weight(gan.factor, self.step,
                              threshold=gan.disc_start,
                              warm_up_end=gan.warm_up_end).to(dev)
        total = rec_loss + d_weight * factor * g_loss
        text_emb = self._text_embedding(batch)
        if text_emb is not None:
            # the valid tokens' mean against the text embedding
            valid = out.token_valid
            denom = valid.sum(dim=-1, keepdim=True).clamp_min(1)
            img_emb = (out.tokens * valid[..., None]).sum(dim=1) / denom
            c_loss, c_metrics = self.contrastive(img_emb, text_emb)
            total = total + tc.contrastive_weight * c_loss
            metrics.update(c_metrics)
        metrics.update(g_loss=g_loss, d_weight=d_weight, disc_factor=factor,
                       rec_loss=rec_loss,
                       num_clusters=out.num_clusters.float().mean())
        return total, metrics, recon

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One micro-batch: the generator's and the discriminator's
        gradients, folded into their running means, and on every k-th the
        two clipped updates. Returns the metrics (detached)."""
        if self.gen_opt is None:
            raise RuntimeError("init_state() first")
        gold = batch["gen_image"]

        # ---------------- generator ----------------
        total, metrics, recon = self.generator_terms(batch, generator)
        grads = torch.autograd.grad(total, self.gen_params,
                                    allow_unused=True)
        gen_grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self.gen_params, grads)]
        metrics["grad_norm"] = global_norm(gen_grads)

        # ---------------- discriminator ----------------
        recon_sg = recon.detach()
        logits_real = self.disc(gold)
        logits_fake = self.disc(recon_sg)
        d_loss = discriminator_loss(logits_real, logits_fake, self.step,
                                    self.gan_cfg)
        disc_grads = list(torch.autograd.grad(d_loss, self.disc_params))
        metrics.update(total_loss=total, d_loss=d_loss,
                       logits_real=logits_real.mean(),
                       logits_fake=logits_fake.mean())

        tc = self.train_cfg
        n = self.step % tc.grad_accum_steps
        self._acc = accumulate(self._acc, gen_grads + disc_grads, n)
        self.step += 1
        if n == tc.grad_accum_steps - 1:
            ng = len(gen_grads)
            gen_lr = self.lr()
            optimizer_step(self.gen_opt, self.gen_params, self._acc[:ng],
                           tc.max_grad_norm, lambda group: gen_lr)
            optimizer_step(self.disc_opt, self.disc_params, self._acc[ng:],
                           tc.max_grad_norm,
                           lambda group: tc.disc_learning_rate)
            self.updates += 1
            self._acc = None
        return {key: v.detach() for key, v in metrics.items()}


@torch.no_grad()
def eval_step(trainer: Stage1Trainer,
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Reconstruction quality of a held-out batch through the inference
    forward: PSNR, SSIM and the mean cluster count."""
    out = trainer.model(batch["comp_image"])
    gold = batch["gen_image"]
    return {"psnr": quality.psnr(out.recon, gold),
            "ssim": quality.ssim(out.recon, gold),
            "num_clusters": out.num_clusters.float().mean()}


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """PSNR for [-1, 1] images (data_range 2), the MSE floored at 1e-10."""
    mse = ((pred.float() - target.float()) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-10))
