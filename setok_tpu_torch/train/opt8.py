"""Adam with block-wise int8 moments: the JAX package's `adam8bit`.

The counterpart of `setok_tpu/train/opt8.py`. Each parameter's two moments
are stored as int8 payloads in blocks of `BLOCK` = 256 elements, each block
with a float32 scale absmax/127 (absmax floored at 1e-12); the second
moment is stored in sqrt space. A step dequantises both, runs Adam in
float32 and quantises them again:

    count += 1;  lr = schedule(count)           (after the increment)
    m = b1·m + (1 - b1)·g;  v = b2·v + (1 - b2)·g²
    step = -lr · (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps)
    p = (p + step) cast to p's type

with no weight decay. The schedule is read at the count after the
increment, where `optax.adamw` reads it before: the caller gives each
group's `lr` for the new count (train/stage2.py, train/stage1.py).

The blocks follow the JAX leaf's layout: each parameter is blocked in the
element order of its flax array (a Dense kernel (in, out) is the torch
weight transposed, a convolution is HWIO), given per parameter as the
permutation of its dimensions (`flax_perm`). The torch (out, in) order
would put other elements in a block and give other scales.

absmax/127 is taken as absmax times float32(1/127), on the CPU and on the
card: XLA compiles the JAX package's `/ 127.0` into that product under
`jit`, where the JAX trainers run `adam8bit` (an eager call divides, and
differs from it in ~4 % of the scales); a product rounds the same on every
device, and so the payloads and scales agree with the JAX trainers'
(tests/test_torch_opt8.py counts the elements that differ).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

BLOCK = 256
# 1/127 rounded to float32, the constant XLA multiplies by for `x / 127.0`
RECIP_127 = float(torch.tensor(1 / 127, dtype=torch.float32))


def flax_perm(module: nn.Module, leaf: str, param: torch.Tensor
              ) -> Tuple[int, ...]:
    """The permutation of `param`'s dimensions that gives its flax array's
    element order (the inverse of `utils/from_flax`'s conversions): a 2-D
    `weight` of anything but an embedding is a transposed kernel (the
    patch-embed matmul's (C, p·p·3) included: its flax (p, p, 3, C) kernel
    flattens in the same order as the transpose), a 4-D one an OIHW
    convolution (HWIO in flax); every other leaf keeps its order."""
    if leaf == "weight" and not isinstance(module, nn.Embedding):
        if param.dim() == 2:
            return (1, 0)
        if param.dim() == 4:
            return (2, 3, 1, 0)
    return tuple(range(param.dim()))


def module_perms(*modules: nn.Module) -> dict:
    """{parameter: flax_perm} for every parameter of `modules`."""
    out = {}
    for model in modules:
        for mod in model.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                out[p] = flax_perm(mod, leaf, p)
    return out


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat float32 x → (int8 (n_blocks, BLOCK), float32 (n_blocks, 1)
    scales), x zero-padded to whole blocks."""
    flat = x.reshape(-1)
    flat = nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) \
        * RECIP_127
    q = torch.round(blocks / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """The first n elements of (q·scale), flat, float32."""
    return (q.float() * scale).reshape(-1)[:n]


class Adam8bit(torch.optim.Optimizer):
    """Adam with int8 block-quantised moments (`adam8bit` of the JAX
    package). Each param group may hold `flax_perms`, the `flax_perm` of
    each of its parameters (default: their own order). The state of a
    parameter: 'count', 'm_q' / 'm_s' (payload, scales) and 'v_q' / 'v_s'
    (of sqrt(v)). Gradients are read as float32."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    def load_state_dict(self, state_dict: dict) -> None:
        """`Optimizer.load_state_dict`, with the float32 scales kept
        float32 (the base class casts floating state to the parameter's
        type, which would round them to bf16 under bf16 parameters)."""
        scales = {i: {k: st[k] for k in ("m_s", "v_s") if k in st}
                  for i, st in state_dict["state"].items()}
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        for i, kept in scales.items():
            p = params[int(i)]
            for k, v in kept.items():
                self.state[p][k] = v.to(p.device, torch.float32)

    @staticmethod
    def _init(p: torch.Tensor) -> dict:
        zeros = torch.zeros(-(-p.numel() // BLOCK), BLOCK, dtype=torch.int8,
                            device=p.device)
        scale = torch.full((zeros.shape[0], 1), 1e-12, device=p.device) \
            * RECIP_127
        return {"count": 0, "m_q": zeros, "m_s": scale,
                "v_q": zeros.clone(), "v_s": scale.clone()}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps = group["eps"]
            perms = group.get("flax_perms") or [None] * len(group["params"])
            for p, perm in zip(group["params"], perms):
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._init(p))
                st["count"] += 1
                count = st["count"]
                perm = perm or tuple(range(p.dim()))
                view = p.grad.permute(perm)
                g = view.float().reshape(-1)
                n = g.numel()
                m = dequantize(st["m_q"], st["m_s"], n)
                v = dequantize(st["v_q"], st["v_s"], n)
                v = v * v
                m = b1 * m + (1.0 - b1) * g
                v = b2 * v + (1.0 - b2) * (g * g)
                # device scalars: PyTorch's CUDA divides by a Python float
                # as a product with its reciprocal
                lr, bc1, bc2 = torch.tensor(
                    [group["lr"], bias_correction(b1, count),
                     bias_correction(b2, count)], device=p.device)
                step = (-lr * (m / bc1)) / (sqrt32(v / bc2) + eps)
                st["m_q"], st["m_s"] = quantize(m)
                st["v_q"], st["v_s"] = quantize(sqrt32(v))
                step = step.reshape(view.shape).permute(
                    _inverse(perm))
                if p.dtype == torch.float32:
                    p.add_(step)
                else:
                    p.copy_((p.float() + step).to(p.dtype))
                del m, v, g, step


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float32 x (through float64,
    whose rounding to float32 is then exact): PyTorch's CPU float32 `sqrt`
    may take a vector-math library's, which is not (14 of 2,310 elements
    differed from XLA's in a test)."""
    return x.double().sqrt().float()


def bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, the power by the C library's `powf` (as
    XLA's CPU build takes it; PyTorch's float32 power differs from it in
    the last bit, e.g. 0.999^3)."""
    d = np.float32(decay)
    return float(np.float32(1.0) - np.power(d, np.float32(count)))


def _inverse(perm: Tuple[int, ...]) -> Tuple[int, ...]:
    out = [0] * len(perm)
    for i, d in enumerate(perm):
        out[d] = i
    return tuple(out)


def moment_bytes(opt: Optional[torch.optim.Optimizer]) -> int:
    """Bytes held by the int8 moment payloads and their scales (the JAX
    `moment_bytes` of an `adam8bit` state, less its count)."""
    if opt is None:
        return 0
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for k, t in st.items() if k in ("m_q", "m_s", "v_q", "v_s"))
