"""Stage-2/3 Setokim training: multimodal CE + the MAR diffusion loss.

The counterpart of `setok_tpu/train/stage2.py` on one card. Each parameter
gets a label from its name, as `Stage2Trainer._label_of` gives it in the
JAX package: 'main' (scheduled learning rate), 'proj_in' / 'proj_out' (the
projectors' constant rates), 'lora' (the adapters, scheduled) or 'frozen'
(`requires_grad=False`, in no optimizer group). The update is the JAX
optimizer chain's:

  * k = `grad_accum_steps` micro-batches per update, their gradients
    averaged as `optax.MultiSteps` does (acc += (g - acc)/(n + 1));
  * the global-norm clip over the trainable gradients, applied to the
    average: g / norm · max_norm where norm ≥ max_norm (optax's rule, not
    `clip_grad_norm_`'s);
  * AdamW (eps 1e-8, the config's betas and weight decay) per group, the
    scheduled groups at `optax.warmup_cosine_decay_schedule(0, lr, warmup,
    total)` of the update count before the update, with warmup =
    min(warmup_steps, total_steps - 1): the first update runs at lr 0.

`train_step(batch, generator | draws)` runs one micro-batch; the update
happens on every k-th. Left out, each raising `NotImplementedError` with its
ROADMAP.md entry: `quant_base` (QLoRA), `optim_bits=8`, `ring_mesh` and
`unfreeze_mm_vision_tower`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch

from setok_tpu_torch.config import SetokimConfig, TrainConfig
from setok_tpu_torch.models.setokim import ForwardDraws, Setokim
from setok_tpu_torch.train.lora import Lora, apply_lora, merge_lora
from setok_tpu_torch.utils.init import init_lora_random

NOT_PORTED = {
    "quant_base": "QLoRA (train/qlora.py): ROADMAP.md, Queue A (stage-2 "
                  "options)",
    "optim_bits": "8-bit AdamW moments (train/opt8.py): ROADMAP.md, Queue A "
                  "(stage-2 options)",
    "ring_mesh": "sequence-parallel training: ROADMAP.md, Queue A "
                 "(parallel)",
    "unfreeze_mm_vision_tower": "training the vision tower: ROADMAP.md, "
                                "Queue A (stage-2 options)",
}
SCHEDULED = ("main", "lora")


def warmup_cosine(count: int, peak: float, warmup: int, total: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total) at
    `count`: linear from 0 over `warmup` steps, then cosine to 0 at
    `total`."""
    if count < warmup:
        return peak * min(max(count, 0), warmup) / warmup
    decay = total - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup, got "
                         f"{total} and {warmup}")
    c = min(count - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares (optax.global_norm)."""
    return torch.sqrt(sum((g * g).sum() for g in grads))


def clip_by_global_norm(grads, max_norm: float) -> list:
    """optax.clip_by_global_norm: every gradient g / norm · max_norm where
    the global norm is at least max_norm (not `clip_grad_norm_`'s rule)."""
    norm = global_norm(grads)
    clip = norm >= max_norm
    return [torch.where(clip, g / norm * max_norm, g) for g in grads]


def accumulate(acc, grads, n: int):
    """optax.MultiSteps' running mean of the micro-batches' gradients: the
    first micro-batch's (n = 0), then acc += (g - acc) / (n + 1)."""
    if n == 0:
        return grads
    for a, g in zip(acc, grads):
        a.add_((g - a) / (n + 1))
    return acc


@torch.no_grad()
def optimizer_step(opt: torch.optim.Optimizer, params, grads,
                   max_norm: float, lr) -> None:
    """One update of `opt`: the gradients clipped to `max_norm` (0: not at
    all) by their global norm, each group at the rate `lr(group)`."""
    if max_norm > 0:
        grads = clip_by_global_norm(grads, max_norm)
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr(group)
    opt.step()
    opt.zero_grad(set_to_none=True)


@dataclasses.dataclass(eq=False)
class Stage2Trainer:
    cfg: SetokimConfig
    train_cfg: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    target_token_id: int = 3
    pad_token_id: int = 0
    freeze_backbone: bool = False
    tune_mm_in_mlp_adapter: bool = False
    tune_mm_out_mlp_adapter: bool = False
    freeze_mm_in_mlp_adapter: bool = False
    freeze_mm_out_mlp_adapter: bool = False
    unfreeze_mm_vision_tower: bool = False
    mm_in_projector_lr: Optional[float] = None
    mm_out_projector_lr: Optional[float] = None
    lora_enable: bool = False
    lora_r: int = 64
    lora_alpha: float = 16.0
    quant_base: bool = False
    use_flash: bool = False
    optim_bits: int = 32
    ring_mesh: Any = None
    device: Any = None

    def __post_init__(self):
        for name, on in (("quant_base", self.quant_base),
                         ("optim_bits", self.optim_bits != 32),
                         ("ring_mesh", self.ring_mesh is not None),
                         ("unfreeze_mm_vision_tower",
                          self.unfreeze_mm_vision_tower)):
            if on:
                raise NotImplementedError(f"{name}: {NOT_PORTED[name]}")
        tc = self.train_cfg
        if tc.param_dtype != "float32":
            raise ValueError(f"param_dtype {tc.param_dtype}: the port's "
                             "trainers keep float32 parameters (ROADMAP.md, "
                             "Queue A item 1)")
        self.model = Setokim(self.cfg, self.target_token_id,
                             self.pad_token_id,
                             dtype=getattr(torch, tc.compute_dtype),
                             use_flash=self.use_flash, remat=tc.remat,
                             device=self.device)
        self.warmup = min(tc.warmup_steps, max(tc.total_steps - 1, 0))
        self.lora: Lora = {}
        self.optimizer: Optional[torch.optim.Optimizer] = None

    # ------------------------------------------------------------------
    def _label_of(self, name: str, in_lora_tree: bool) -> str:
        if in_lora_tree:
            return "lora"
        if "vision_tower" in name:
            return "main" if self.unfreeze_mm_vision_tower else "frozen"
        if "vision_generator" in name:
            return "frozen"
        if "mm_in_projector" in name:
            return "frozen" if self.freeze_mm_in_mlp_adapter else "proj_in"
        if "mm_out_projector" in name:
            return "frozen" if self.freeze_mm_out_mlp_adapter else "proj_out"
        if "diffloss" in name:
            return "main"
        adapters_only = (self.tune_mm_in_mlp_adapter
                         or self.tune_mm_out_mlp_adapter)
        if self.freeze_backbone or adapters_only or self.lora_enable:
            return "frozen"
        return "main"

    def labels(self) -> Dict[str, str]:
        """Label of each model parameter (state-dict name) and each adapter
        ('lora.<module>.a' / '.b')."""
        out = {name: self._label_of(name, False)
               for name, _ in self.model.named_parameters()}
        for name in self.lora:
            out[f"lora.{name}.a"] = out[f"lora.{name}.b"] = "lora"
        return out

    def init_state(self, seed: int = 0, lora: Optional[Lora] = None) -> None:
        """Adapters (given, or drawn from `seed` when `lora_enable`), the
        frozen flags, the optimizer groups and the step counters. The
        model's weights are the caller's (utils/init or from_flax)."""
        if self.lora_enable:
            if lora is None:
                lora = init_lora_random(self.model, seed, self.lora_r)
            self.lora = lora
        apply_lora(self.model, self.lora, self.lora_alpha, self.lora_r)
        tc = self.train_cfg
        groups = {"main": [], "proj_in": [], "proj_out": [], "lora": []}
        for name, p in self.model.named_parameters():
            label = self._label_of(name, False)
            p.requires_grad_(label != "frozen")
            if label != "frozen":
                groups[label].append(p)
        for a, b in self.lora.values():
            groups["lora"] += [a, b]
        const = {"proj_in": self.mm_in_projector_lr or tc.learning_rate,
                 "proj_out": self.mm_out_projector_lr or tc.learning_rate}
        self.optimizer = torch.optim.AdamW(
            [{"params": ps, "label": label,
              "lr": const.get(label, tc.learning_rate)}
             for label, ps in groups.items() if ps],
            betas=(tc.beta1, tc.beta2), eps=1e-8,
            weight_decay=tc.weight_decay)
        self.trainable = [p for g in self.optimizer.param_groups
                          for p in g["params"]]
        self.step = 0            # micro-batches
        self.updates = 0         # optimizer updates
        self._acc = None

    def lr(self, label: str) -> float:
        """The learning rate the next update gives a group."""
        tc = self.train_cfg
        if label in SCHEDULED:
            return warmup_cosine(self.updates, tc.learning_rate, self.warmup,
                                 tc.total_steps)
        return {"proj_in": self.mm_in_projector_lr,
                "proj_out": self.mm_out_projector_lr}[label] \
            or tc.learning_rate

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor],
                   rng: Union[torch.Generator, ForwardDraws]
                   ) -> Dict[str, torch.Tensor]:
        """One micro-batch: the forward (draws from `rng`, or the given
        draws), its gradients folded into the running mean, and on every
        k-th micro-batch the clipped AdamW update. Returns the losses."""
        if self.optimizer is None:
            raise RuntimeError("init_state() first")
        ids = batch["input_ids"]
        draws = (rng if isinstance(rng, ForwardDraws)
                 else self.model.draw_forward(ids.shape[0], rng))
        out = self.model(ids, batch["comp_image"], batch["labels"],
                         batch.get("gen_image"), draws)
        grads = torch.autograd.grad(out.loss, self.trainable,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.trainable, grads)]
        k = self.train_cfg.grad_accum_steps
        n = self.step % k
        self._acc = accumulate(self._acc, grads, n)
        self.step += 1
        if n == k - 1:
            optimizer_step(self.optimizer, self.trainable, self._acc,
                           self.train_cfg.max_grad_norm,
                           lambda group: self.lr(group["label"]))
            self.updates += 1
            self._acc = None
        return {"lm_loss": out.lm_loss.detach(),
                "diff_loss": out.diff_loss.detach(),
                "total_loss": out.loss.detach()}

    def state_dict(self, generators: Optional[Dict[str, torch.Generator]]
                   = None) -> Dict[str, Any]:
        """The run's state in three parts, as the JAX `Stage2State` holds
        it (utils/checkpoint writes each to a file of its own): 'params'
        (the model's state dict), 'lora' ({'<module>.a': A, '<module>.b':
        B}) and 'train' (the optimizer's state with the Adam moments, the
        micro-batch and update counts, the accumulated gradients and the
        state of each of `generators`, the caller's). Tensors are the live
        ones: `to_host` or a checkpoint save copies them."""
        if self.optimizer is None:
            raise RuntimeError("init_state() first")
        lora = {}
        for name, (a, b) in self.lora.items():
            lora[f"{name}.a"], lora[f"{name}.b"] = a, b
        return {"params": self.model.state_dict(), "lora": lora, "train": {
            "optimizer": self.optimizer.state_dict(),
            "step": self.step, "updates": self.updates, "acc": self._acc,
            "generators": {k: g.get_state()
                           for k, g in (generators or {}).items()}}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any],
                        generators: Optional[Dict[str, torch.Generator]]
                        = None) -> None:
        """Restore a `state_dict()` into a trainer built with the same
        configuration and `init_state()`: parameters, adapters, optimizer
        state, counts, accumulated gradients, and the states of
        `generators` (each name must be in the state)."""
        if self.optimizer is None:
            raise RuntimeError("init_state() first")
        self.model.load_state_dict(state["params"], strict=True)
        lora = state["lora"]
        if set(lora) != {f"{n}.{f}" for n in self.lora for f in "ab"}:
            raise KeyError("the checkpoint's adapters differ from the "
                           "trainer's")
        for name, (a, b) in self.lora.items():
            a.copy_(lora[f"{name}.a"])
            b.copy_(lora[f"{name}.b"])
        train = state["train"]
        self.optimizer.load_state_dict(train["optimizer"])
        self.step, self.updates = int(train["step"]), int(train["updates"])
        dev = self.model.device
        self._acc = (None if train["acc"] is None else
                     [t.to(dev) for t in train["acc"]])
        for key, g in (generators or {}).items():
            g.set_state(train["generators"][key].cpu())

    def merged_params(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the adapters merged in."""
        return merge_lora(self.model.state_dict(), self.lora,
                          self.lora_alpha, self.lora_r)
