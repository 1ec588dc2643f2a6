"""Image-text contrastive loss: InfoNCE and the multi-label branch.

The counterpart of `setok_tpu/losses/contrastive.py`: a CLIP-style InfoNCE
over L2-normalised (B, C) embeddings with a learned temperature
(`logit_scale`, exp clamped to 100, initialised at log(1/T)), and, when
`multi_label` > 0, GroupViT's multi-label soft cross-entropy over (B, L, C)
sets with its own temperature (`multi_label_logit_scale`) unless
`share_temperature`. Both run in float32.

The JAX package gathers the negatives of every data shard (`all_gather`
over the mesh's data axis). Here `group` (the data ranks' process group,
set by the trainer; None on one process) plays that axis: `_gather` is a
differentiable all-gather whose backward sums the ranks' gradients (the
transpose of `jax.lax.all_gather`), the InfoNCE labels are arange(b) +
b·rank, and the multi-label soft targets lie in the rank's own slot.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from setok_tpu_torch.config import ContrastiveLossConfig
from setok_tpu_torch.parallel import comm
from setok_tpu_torch.utils.device import resolve_device


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """dist_collect: (b, ...) → (world·b, ...) over `group`,
    differentiable; x itself without a group."""
    return comm.gather_summed(x, 0, group)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


class ContrastiveLoss(nn.Module):
    def __init__(self, cfg: ContrastiveLossConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        # the data ranks' process group (None: one process)
        self.group = None
        self.logit_scale = nn.Parameter(torch.zeros((), device=device))
        self.multi_label_logit_scale = None
        if cfg.multi_label > 0 and not cfg.share_temperature:
            self.multi_label_logit_scale = nn.Parameter(
                torch.zeros((), device=device))
        self.init_fixed_()

    @torch.no_grad()
    def init_fixed_(self) -> None:
        """Both temperatures at log(1/contrast_temperature)."""
        init = math.log(1.0 / self.cfg.contrast_temperature)
        for p in self.parameters():
            p.fill_(init)

    def _scale(self, shared: bool = True) -> torch.Tensor:
        p = (self.logit_scale if shared or self.cfg.share_temperature
             else self.multi_label_logit_scale)
        return torch.exp(p).clamp(max=100.0)

    def info_nce(self, image_x: torch.Tensor,
                 text_x: torch.Tensor) -> torch.Tensor:
        """InfoNCE of (B, C) image and text embeddings, both directions."""
        b = image_x.shape[0]
        rank = comm.group_rank(self.group)
        labels = torch.arange(b, device=image_x.device) + b * rank
        image_x = _normalize(image_x.float())
        text_x = _normalize(text_x.float())
        logits_per_img = image_x @ _gather(text_x, self.group).t()
        logits_per_text = text_x @ _gather(image_x, self.group).t()
        scale = self._scale()
        return 0.5 * (_cross_entropy(logits_per_img * scale, labels)
                      + _cross_entropy(logits_per_text * scale, labels))

    def multi_label_loss(self, image_feat: torch.Tensor,
                         text_feat: torch.Tensor) -> torch.Tensor:
        """Multi-label soft cross-entropy of (B, L1, C) and (B, L2, C) sets:
        each row's uniform target mass lies on its own sample's block."""
        b, l1, _ = image_feat.shape
        l2 = text_feat.shape[1]
        image_x = _normalize(image_feat.float()).reshape(b * l1, -1)
        text_x = _normalize(text_feat.float()).reshape(b * l2, -1)
        scale = self._scale(shared=False)
        idx = torch.arange(b, device=image_x.device)
        world = comm.group_size(self.group)
        rank = comm.group_rank(self.group)

        def masked_ce(logits, l_row, l_col):
            logp = F.log_softmax(logits * scale, dim=-1)
            # the own sample's block in the own rank's slot
            own = logp.reshape(b, l_row, world, b, l_col)[:, :, rank]
            own = own[idx, :, idx, :]
            return (-own.sum(dim=-1) / l_col).mean()

        g = self.group
        return 0.5 * (masked_ce(image_x @ _gather(text_x, g).t(), l1, l2)
                      + masked_ce(text_x @ _gather(image_x, g).t(), l2, l1))

    def forward(self, image_x: torch.Tensor, text_x: torch.Tensor):
        """(loss, metrics) of (B, C) pooled image tokens and encoded
        text."""
        loss = self.info_nce(image_x, text_x)
        metrics = {"contrastive_loss": loss}
        if self.cfg.multi_label > 0:
            ml = self.multi_label_loss(image_x[:, None, :], text_x[:, None, :])
            ml = ml * self.cfg.multi_label_loss_weight
            loss = loss + ml
            metrics["multi_label_loss"] = ml
        return loss, metrics
