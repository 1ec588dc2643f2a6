"""Stage-2/3 Setokim training: multimodal CE + the MAR diffusion loss.

The counterpart of `setok_tpu/train/stage2.py`. Each parameter gets a
label from its name, as `Stage2Trainer._label_of` gives it in the
JAX package: 'main' (scheduled learning rate), 'embed32' (the embedding
table under 8-bit moments: 32-bit AdamW, scheduled), 'proj_in' /
'proj_out' (the projectors' constant rates), 'lora' (the adapters,
scheduled) or 'frozen' (`requires_grad=False`, in no optimizer group). The
update is the JAX optimizer chain's:

  * k = `grad_accum_steps` micro-batches per update, their gradients
    averaged as `optax.MultiSteps` does (acc += (g - acc)/(n + 1));
  * the global-norm clip over the trainable gradients, applied to the
    average in place, tensor by tensor: g / norm · max_norm where norm ≥
    max_norm (optax's rule, not `clip_grad_norm_`'s);
  * per group, AdamW (eps 1e-8, the config's betas and weight decay) at
    `optax.warmup_cosine_decay_schedule(0, lr, warmup, total)` of the
    update count before the update, with warmup = min(warmup_steps,
    total_steps - 1): the first update runs at lr 0. Float32 parameters
    take `torch.optim.AdamW`; others (`TrainConfig.param_dtype` bf16) take
    `AdamWOptax`, optax's steps in the moments' type (the parameter's, as
    optax keeps them);
  * `optim_bits=8`: the 'main', 'proj_in', 'proj_out' and 'lora' groups
    take `opt8.Adam8bit` (int8 moments, no weight decay), which reads the
    schedule after the increment (its first update moves); 'embed32'
    keeps AdamW.

Options: `param_dtype` (TrainConfig; the model's parameters and adapters
in that type), `quant_base` (QLoRA, train/qlora.py: the targeted trunk
linears int8 under the adapters; needs `lora_enable`),
`unfreeze_mm_vision_tower` (the tower's trainable part under 'main';
its backbone and clustering take no gradient). `train_step(batch,
generator | draws)` runs one micro-batch; the update happens on every k-th.

Over several processes (parallel/, one per card, `torchrun`):
  * `mesh` (data, model) from parallel/mesh.make_mesh: data parallelism
    with the FSDP rule (parallel/sharding.Fsdp: each trunk block gathers
    its parameters around its forward, the rest are gathered for the
    step) and Megatron tensor parallelism of the trunk over `model`
    (models/llama.tensor_parallel_); TP slices are not sharded over
    `data`, as under the JAX `setokim_shardings`;
  * `ring_mesh` (data, seq) from parallel/mesh.make_sp_mesh: the same FSDP
    over `data`, and the trunk's sequence split over `seq` with ring
    attention (models/llama.ring_forward).
Each data rank takes its rows of the global batch and of the global
draws; the losses' denominators (the CE's supervised tokens, the
diffusion mask) are summed over the data ranks, so the ranks' losses sum
to the global batch's and their gradients are summed. The `seq` ranks
compute the same loss; its backward is scaled by 1/seq and the gradients
summed. The clip's global norm sums the squares of every slice over the
ranks that hold it. 8-bit moments keep whole blocks per rank
(sharding.Fsdp's `block_params`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from setok_tpu_torch.config import SetokimConfig, TrainConfig
from setok_tpu_torch.models.setokim import (DiffusionDraws, ForwardDraws,
                                            Setokim)
from setok_tpu_torch.parallel import comm
from setok_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                           axis_group, axis_rank, axis_size,
                                           check_backend)
from setok_tpu_torch.parallel.sharding import (Fsdp, Piece, gather_layout,
                                               sharded_sq_norm)
from setok_tpu_torch.train.lora import Lora, apply_lora, merge_lora
from setok_tpu_torch.train.opt8 import (BLOCK, Adam8bit, bias_correction,
                                        module_perms)
from setok_tpu_torch.train.qlora import dequantize, quantize_base
from setok_tpu_torch.utils.from_flax import flax_entries
from setok_tpu_torch.utils.init import init_lora_random

SCHEDULED = ("main", "embed32", "lora")
# the groups that `optim_bits=8` gives int8 moments
EIGHT_BIT = ("main", "proj_in", "proj_out", "lora")
# the order of the optimizers and of their groups (that of the gradients'
# global norm)
KINDS = ("adamw", "adamw_optax", "adam8bit")
LABELS = ("main", "embed32", "proj_in", "proj_out", "lora")


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


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, order=None,
                         norm=None) -> None:
    """optax.clip_by_global_norm in place: every gradient becomes g / norm
    · max_norm (the norm cast to g's type) where the global norm is at
    least max_norm (not `clip_grad_norm_`'s rule). The norm sums the
    gradients in `order` (indices; default their own): the JAX tree's leaf
    order, on which a bf16 norm's roundings depend; or it is given (a
    sharded trainer's, over the ranks). One tensor's temporaries at a
    time, and no host sync."""
    if norm is None:
        norm = global_norm(grads if order is None
                           else [grads[i] for i in order])
    clip = norm >= max_norm
    for g in grads:
        # max_norm in g's type, as JAX's weak type gives it
        scale = torch.tensor(max_norm, dtype=g.dtype, device=g.device)
        torch.where(clip, g / norm.to(g.dtype) * scale, g, out=g)


def accumulate(acc, grads, n: int):
    """optax.MultiSteps' running mean of the micro-batches' gradients: the
    first micro-batch's (n = 0), then acc += (g - acc) / (n + 1)."""
    if n == 0:
        return grads
    for a, g in zip(acc, grads):
        a.add_((g - a) / (n + 1))
    return acc


class AdamWOptax(torch.optim.Optimizer):
    """`optax.adamw` in the order and the type optax 0.2.6 takes with
    moments in a low-precision parameter's type (bf16): mu = (1-b1)·g +
    b1·mu and nu = (1-b2)·g² + b2·nu in that type (the scalars rounded to
    it first, as JAX's weak types are), count += 1, mu / (1 - b1^count)
    and nu / (1 - b2^count) with each correction computed in float32 then
    cast, u = mu_hat / (sqrt(nu_hat) + eps), + weight_decay·p, times the
    learning rate cast to the type, and p + u in the type.
    `torch.optim.AdamW` orders these steps otherwise (lerp, float bias
    corrections, the decay first); for float32 parameters it agrees with
    optax and the trainers keep it there."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(count=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
                dt, g = p.dtype, p.grad

                def c(x):
                    return torch.tensor(x, dtype=dt, device=p.device)

                st["mu"] = c(1 - b1) * g + c(b1) * st["mu"]
                st["nu"] = c(1 - b2) * (g * g) + c(b2) * st["nu"]
                st["count"] += 1
                bc1 = c(bias_correction(b1, st["count"]))
                bc2 = c(bias_correction(b2, st["count"]))
                root = (st["nu"] / bc2).double().sqrt().to(dt)
                u = (st["mu"] / bc1) / (root + c(group["eps"]))
                if group["weight_decay"]:
                    u = u + c(group["weight_decay"]) * p
                p.copy_(p + c(-group["lr"]) * u)


def make_optimizer(kind: str, groups: list, tc: TrainConfig):
    """The optimizer of one kind ('adam8bit', 'adamw' for float32,
    'adamw_optax' for other parameter types) over its param groups."""
    betas = (tc.beta1, tc.beta2)
    if kind == "adam8bit":
        return Adam8bit(groups, betas=betas)
    cls = torch.optim.AdamW if kind == "adamw" else AdamWOptax
    return cls(groups, betas=betas, eps=1e-8, weight_decay=tc.weight_decay)


@torch.no_grad()
def optimizer_step(opts, params, grads, max_norm: float, lr,
                   order=None, norm=None) -> None:
    """One update of the optimizer(s) `opts` (one, or a list): the
    gradients clipped to `max_norm` (0: not at all) by their global norm
    (summed in `order`, or `norm` as given), in place, each group at the
    rate `lr(group)`."""
    if max_norm > 0:
        clip_by_global_norm_(grads, max_norm, order, norm)
    for p, g in zip(params, grads):
        p.grad = g
    opts = opts if isinstance(opts, (list, tuple)) else [opts]
    for opt in opts:
        for group in opt.param_groups:
            group["lr"] = lr(group)
        opt.step()
        opt.zero_grad(set_to_none=True)


def shard_draws(draws: ForwardDraws, rank: int, n: int, batch: int,
                tn: int) -> ForwardDraws:
    """Rank `rank`'s rows (`batch` of them) of the draws of a global batch
    of n·batch rows: its rows of the diffusion orders, and of each repeat
    of the flattened (rows, tokens) timesteps and noise."""
    d = draws.diffusion
    if d is None or n == 1:
        return draws
    rows = slice(rank * batch, (rank + 1) * batch)
    per = batch * tn

    def part(x):
        x = x.reshape(-1, n * per, *x.shape[1:])
        return x[:, rank * per:(rank + 1) * per].reshape(-1, *x.shape[2:])

    return ForwardDraws(draws.dropout, DiffusionDraws(
        d.orders[rows], d.rate, part(d.t), part(d.noise)))


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
    mesh: Any = None
    device: Any = None

    def __post_init__(self):
        if self.ring_mesh is not None and self.mesh is not None:
            raise ValueError("ring_mesh and mesh are exclusive (one trunk "
                             "mesh)")
        if self.quant_base and not self.lora_enable:
            raise ValueError("quant_base (QLoRA) requires lora_enable: the "
                             "int8 base is frozen; adapters carry training")
        if self.optim_bits not in (32, 8):
            raise ValueError(f"optim_bits must be 32 or 8, got "
                             f"{self.optim_bits}")
        tc = self.train_cfg
        self.model = Setokim(self.cfg, self.target_token_id,
                             self.pad_token_id,
                             dtype=getattr(torch, tc.compute_dtype),
                             param_dtype=getattr(torch, tc.param_dtype),
                             use_flash=self.use_flash, remat=tc.remat,
                             ring_mesh=self.ring_mesh, device=self.device)
        check_backend(self.model.device)
        self.fsdp: Optional[Fsdp] = None
        # id(tensor) → (its Piece of the full tensor, the group over which
        # the pieces lie) for every sharded parameter and adapter
        self._pieces: Dict[int, tuple] = {}
        self._tp_partial: set = set()
        self.warmup = min(tc.warmup_steps, max(tc.total_steps - 1, 0))
        self.lora: Lora = {}
        self.optimizers: Dict[str, torch.optim.Optimizer] = {}

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
        if self.optim_bits == 8 and "embed_tokens" in name:
            return "embed32"
        return "main"

    def labels(self) -> Dict[str, str]:
        """Label of each model parameter (state-dict name) and each adapter
        ('lora.<module>.a' / '.b')."""
        out = {name: self._label_of(name, False)
               for name, _ in self.model.named_parameters()}
        for name in self.lora:
            out[f"lora.{name}.a"] = out[f"lora.{name}.b"] = "lora"
        return out

    def _kind(self, label: str, p: torch.Tensor) -> str:
        """The optimizer of a parameter: 'adam8bit' for the 8-bit groups,
        else 'adamw' (float32) or 'adamw_optax' (another type)."""
        if self.optim_bits == 8 and label in EIGHT_BIT:
            return "adam8bit"
        return "adamw" if p.dtype == torch.float32 else "adamw_optax"

    def init_state(self, seed: int = 0, lora: Optional[Lora] = None) -> None:
        """Adapters (given, or drawn from `seed` when `lora_enable`), the
        int8 base under `quant_base` (quantised after the adapters are
        drawn, as the JAX trainer does), the frozen flags, the optimizers'
        groups and the step counters. The model's weights are the caller's
        (utils/init or from_flax)."""
        if self.lora_enable:
            if lora is None:
                lora = init_lora_random(self.model, seed, self.lora_r)
            self.lora = lora
        self.qscales = quantize_base(self.model) if self.quant_base else {}
        apply_lora(self.model, self.lora, self.lora_alpha, self.lora_r)
        tc = self.train_cfg
        named = []
        for name, p in self.model.named_parameters():
            label = self._label_of(name, False)
            p.requires_grad_(label != "frozen")
            if label != "frozen":
                named.append((label, p))
        for a, b in self.lora.values():
            named += [("lora", a), ("lora", b)]
        self._shard([p for label, p in named
                     if self._kind(label, p) == "adam8bit"])
        self.step = 0            # micro-batches
        self.updates = 0         # optimizer updates
        self._acc = None
        perms = module_perms(self.model)
        groups: Dict[tuple, list] = {}
        for label, p in named:
            groups.setdefault((self._kind(label, p), label), []).append(p)
        self.optimizers = {}
        for kind in KINDS:
            spec = []
            for label in LABELS:
                ps = groups.get((kind, label))
                if not ps:
                    continue
                group = {"params": ps, "label": label, "lr": self.lr(label)}
                if kind == "adam8bit":
                    group["flax_perms"] = [perms.get(p) for p in ps]
                spec.append(group)
            if spec:
                self.optimizers[kind] = make_optimizer(kind, spec, tc)
        self.trainable = [p for opt in self.optimizers.values()
                          for g in opt.param_groups for p in g["params"]]
        self._norm_order = self._jax_leaf_order()

    # ------------------------------------------------------------------
    @property
    def data_mesh(self):
        return self.mesh if self.mesh is not None else self.ring_mesh

    def _shard(self, blocked: List[torch.Tensor]) -> None:
        """The tensor-parallel slices over `model`, then FSDP over `data`
        of everything else (`blocked`: the 8-bit moments' parameters)."""
        self._pieces, self._tp_partial = {}, set()
        mg = axis_group(self.mesh, MODEL_AXIS)
        if axis_size(self.mesh, MODEL_AXIS) > 1:
            sub = {k[len("llama."):]: v for k, v in self.lora.items()
                   if k.startswith("llama.")}
            pieces = self.model.llama.tensor_parallel_(mg, sub)
            self._pieces = {i: (pc, mg) for i, pc in pieces.items()}
            for a, b in self.lora.values():
                # a column-parallel layer's A and a row-parallel one's B
                # are whole on every rank and get partial gradients
                if id(b) in pieces:
                    self._tp_partial.add(id(a))
                if id(a) in pieces:
                    self._tp_partial.add(id(b))
        dmesh = self.data_mesh
        self.model.count_group = axis_group(dmesh, DATA_AXIS)
        if dmesh is not None:
            tp = [p for p in self.model.parameters()
                  if id(p) in self._pieces]
            trunk = self.model.llama.model
            units = [getattr(trunk, f"layer_{i}")
                     for i in range(self.cfg.llama.num_layers)]
            self.fsdp = Fsdp(self.model, dmesh, units=units, skip=tp,
                             block_params=blocked, block=BLOCK)
            for p in self.model.parameters():
                if self.fsdp.is_sharded(p):
                    self._pieces[id(p)] = (self.fsdp.pieces[id(p)],
                                           self.fsdp.group)

    def _sync_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum each gradient over the ranks that computed a part of it:
        the data ranks (unless the FSDP gather's backward did), the seq
        ranks, and the model ranks for an adapter whole on each."""
        dg = axis_group(self.data_mesh, DATA_AXIS)
        sg = axis_group(self.ring_mesh, SEQ_AXIS)
        mg = axis_group(self.mesh, MODEL_AXIS)
        whole = [g for p, g in zip(self.trainable, grads)
                 if self.fsdp is None or not self.fsdp.is_sharded(p)]
        comm.all_reduce_many(whole, dg)
        comm.all_reduce_many(grads, sg)
        comm.all_reduce_many([g for p, g in zip(self.trainable, grads)
                              if id(p) in self._tp_partial], mg)

    def _grad_norm(self, grads) -> Optional[torch.Tensor]:
        """The global norm over the ranks' slices (None on one process)."""
        if not self._pieces:
            return None
        buckets: Dict[tuple, list] = {}
        for p, g in zip(self.trainable, grads):
            pc = self._pieces.get(id(p))
            buckets.setdefault(() if pc is None else (pc[1],), []).append(g)
        return sharded_sq_norm(buckets).to(grads[0].device)

    def _layout(self) -> Dict[str, tuple]:
        """{checkpoint path: (Piece, group)} of every sliced leaf of
        `state_dict()`: parameters, adapters and their optimizer state."""
        from setok_tpu_torch.utils.checkpoint import keystr
        out = {}
        for name, p in self.model.state_dict(keep_vars=True).items():
            if id(p) in self._pieces:
                out[keystr("params", *name.split("."))] = self._pieces[id(p)]
        for name, ab in self.lora.items():
            for f, t in zip("ab", ab):
                if id(t) in self._pieces:
                    out[keystr("lora", *name.split("."), f)] = \
                        self._pieces[id(t)]
        perms = module_perms(self.model)
        for kind, opt in self.optimizers.items():
            i = 0
            for group in opt.param_groups:
                for p in group["params"]:
                    pc = self._pieces.get(id(p))
                    if pc is not None:
                        lead = perms[p][0] if p in perms else 0
                        for key, v in _state_pieces(kind, pc[0],
                                                    lead).items():
                            out[keystr("train", "optimizers", kind, "state",
                                       str(i), key)] = (v, pc[1])
                    i += 1
        return out

    def shardings(self) -> Dict[str, Piece]:
        """{checkpoint path: Piece} of this trainer's slices, for
        `utils/checkpoint.restore_sharded`: a full checkpoint restored
        with it loads into `load_state_dict` on any layout."""
        return {k: v[0] for k, v in self._layout().items()}

    def full_state_dict(self, generators: Optional[Dict[str, torch.Generator]]
                        = None) -> Dict[str, Any]:
        """`state_dict()` with every slice gathered to its full tensor (a
        collective: every rank calls it; one writes the checkpoint). Taken
        between updates (no accumulated gradients)."""
        state = self.state_dict(generators)
        layout = self._layout()
        if layout and state["train"]["acc"] is not None:
            raise RuntimeError("save a sharded trainer between updates")
        return gather_layout(state, layout)

    def _jax_leaf_order(self) -> List[int]:
        """The trainable parameters' indices in the JAX trainer's leaf order
        (its tree {'lora': {kernel keystr: {'a', 'b'}}, 'params': ...}
        flattened with sorted keys; the QLoRA overlay keyed by keystr)."""
        def keystr(path):
            return "".join(f"['{k}']" for k in ("params", *path))

        where = {}
        for path, (key, _) in flax_entries(self.model).items():
            where[key] = (("params", keystr(path)) if self.quant_base
                          else ("params", "params", *path))
        for name, ab in self.lora.items():
            kernel = keystr((*name.split("."), "kernel"))
            for f, t in zip("ab", ab):
                where[id(t)] = ("lora", kernel, f)
        names = {id(p): n for n, p in self.model.named_parameters()}
        keys = [where[names[id(p)]] if id(p) in names else where[id(p)]
                for p in self.trainable]
        return sorted(range(len(keys)), key=keys.__getitem__)

    @property
    def optimizer(self) -> Optional[torch.optim.Optimizer]:
        """The float32 parameters' `torch.optim.AdamW` (None if none)."""
        return self.optimizers.get("adamw")

    def lr(self, label: str) -> float:
        """The learning rate the next update gives a group: the schedule
        at the update count before it, or after it for `Adam8bit`."""
        tc = self.train_cfg
        if label in SCHEDULED:
            count = self.updates
            if self.optim_bits == 8 and label in EIGHT_BIT:
                count += 1
            return warmup_cosine(count, tc.learning_rate, self.warmup,
                                 tc.total_steps)
        return {"proj_in": self.mm_in_projector_lr,
                "proj_out": self.mm_out_projector_lr}[label] \
            or tc.learning_rate

    def _ready(self) -> None:
        if not self.optimizers:
            raise RuntimeError("init_state() first")

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor],
                   rng: Union[torch.Generator, ForwardDraws]
                   ) -> Dict[str, torch.Tensor]:
        """One micro-batch: the forward (draws from `rng`, or the given
        draws), its gradients folded into the running mean, and on every
        k-th micro-batch the clipped update. Returns the losses."""
        self._ready()
        ids = batch["input_ids"]
        dmesh = self.data_mesh
        dp = axis_size(dmesh, DATA_AXIS)
        # the draws of the global batch (given, or from `rng`, alike on
        # every rank), then this data rank's rows of them
        draws = (rng if isinstance(rng, ForwardDraws)
                 else self.model.draw_forward(ids.shape[0] * dp, rng))
        draws = shard_draws(draws, axis_rank(dmesh, DATA_AXIS), dp,
                            ids.shape[0], self.cfg.target_num)
        sp = axis_size(self.ring_mesh, SEQ_AXIS)
        gathered = (self.fsdp.gathered() if self.fsdp is not None
                    else contextlib.nullcontext())
        with gathered:
            out = self.model(ids, batch["comp_image"], batch["labels"],
                             batch.get("gen_image"), draws)
            # the seq ranks compute the same loss (see ring_forward)
            loss = out.loss / sp if sp > 1 else out.loss
            grads = torch.autograd.grad(loss, self.trainable,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.trainable, grads)]
        self._sync_grads(grads)
        k = self.train_cfg.grad_accum_steps
        n = self.step % k
        self._acc = accumulate(self._acc, grads, n)
        del grads
        self.step += 1
        if n == k - 1:
            norm = self._grad_norm(self._acc)
            if norm is None:
                norm = global_norm([self._acc[i] for i in self._norm_order])
            # the global norm before the clip, of this update
            self.last_grad_norm = norm
            optimizer_step(list(self.optimizers.values()), self.trainable,
                           self._acc, self.train_cfg.max_grad_norm,
                           lambda group: self.lr(group["label"]),
                           self._norm_order, norm)
            self.updates += 1
            self._acc = None
        losses = torch.stack([out.lm_loss.detach(), out.diff_loss.detach(),
                              out.loss.detach()])
        # each data rank's losses are its share of the global batch's
        comm.all_reduce_(losses, axis_group(dmesh, DATA_AXIS))
        return dict(zip(("lm_loss", "diff_loss", "total_loss"), losses))

    def state_dict(self, generators: Optional[Dict[str, torch.Generator]]
                   = None) -> Dict[str, Any]:
        """The run's state in three parts, as the JAX `Stage2State` holds
        it (utils/checkpoint writes each to a file of its own): 'params'
        (the model's state dict: under QLoRA the int8 weights and their
        `qscale`), 'lora' ({'<module>.a': A, '<module>.b': B}) and 'train'
        (each optimizer's state by kind, with the Adam moments (int8 with
        their scales under `Adam8bit`), the micro-batch and update counts,
        the accumulated gradients and the state of each of `generators`,
        the caller's). Tensors are the live ones: `to_host` or a checkpoint
        save copies them."""
        self._ready()
        lora = {}
        for name, (a, b) in self.lora.items():
            lora[f"{name}.a"], lora[f"{name}.b"] = a, b
        return {"params": self.model.state_dict(), "lora": lora, "train": {
            "optimizers": {k: opt.state_dict()
                           for k, opt in self.optimizers.items()},
            "step": self.step, "updates": self.updates, "acc": self._acc,
            "generators": {k: g.get_state()
                           for k, g in (generators or {}).items()}}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any],
                        generators: Optional[Dict[str, torch.Generator]]
                        = None) -> None:
        """Restore a `state_dict()` into a trainer built with the same
        configuration and `init_state()`: parameters, adapters, optimizer
        states, counts, accumulated gradients, and the states of
        `generators` (each name must be in the state)."""
        self._ready()
        self.model.load_state_dict(state["params"], strict=True)
        lora = state["lora"]
        if set(lora) != {f"{n}.{f}" for n in self.lora for f in "ab"}:
            raise KeyError("the checkpoint's adapters differ from the "
                           "trainer's")
        for name, (a, b) in self.lora.items():
            a.copy_(lora[f"{name}.a"])
            b.copy_(lora[f"{name}.b"])
        train = state["train"]
        if set(train["optimizers"]) != set(self.optimizers):
            raise KeyError(f"the checkpoint's optimizers "
                           f"{sorted(train['optimizers'])} differ from the "
                           f"trainer's {sorted(self.optimizers)}")
        for kind, opt in self.optimizers.items():
            opt.load_state_dict(train["optimizers"][kind])
        self.step, self.updates = int(train["step"]), int(train["updates"])
        dev = self.model.device
        self._acc = (None if train["acc"] is None else
                     [t.to(dev) for t in train["acc"]])
        for key, g in (generators or {}).items():
            g.set_state(train["generators"][key].cpu())

    def merged_params(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the adapters merged in; under QLoRA
        the int8 weights dequantised to the compute type first (the JAX
        trainer's order), so the merged weights are float and servable."""
        state = self.model.state_dict()
        if self.quant_base:
            state = dequantize(state, getattr(torch,
                                              self.train_cfg.compute_dtype))
        return merge_lora(state, self.lora, self.lora_alpha, self.lora_r)


# the optimizer state leaves laid out like their parameter, by kind
_LIKE_PARAM = {"adamw": ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"),
               "adamw_optax": ("mu", "nu")}


def _state_pieces(kind: str, piece: Piece, lead: int) -> Dict[str, Piece]:
    """The Piece of each optimizer state leaf of a sliced parameter: the
    parameter's own for the AdamW moments; for the 8-bit moments, the
    run of whole blocks of a slice of the flax leading dimension `lead`
    (sharding.Fsdp's rule for them)."""
    if kind != "adam8bit":
        return {k: piece for k in _LIKE_PARAM[kind]}
    if piece.dim != lead:
        raise ValueError("8-bit moments of a slice off the flax leading "
                         "dimension have no layout of whole blocks")
    inner = int(np.prod(piece.full)) // piece.full[piece.dim]
    start, length = piece.start * inner, piece.length * inner
    if start % BLOCK or length % BLOCK:
        raise ValueError("8-bit moments of a slice that splits blocks")
    nb = -(-int(np.prod(piece.full)) // BLOCK)
    blocks = Piece(0, start // BLOCK, length // BLOCK, (nb, BLOCK))
    scales = Piece(0, start // BLOCK, length // BLOCK, (nb, 1))
    return {"m_q": blocks, "v_q": blocks, "m_s": scales, "v_s": scales}
