"""Frozen configuration for the PyTorch SeTok / Setokim port.

A copy of the tokenizer/detokenizer and Setokim parts of `setok_tpu.config`,
with the same field names and the same validation, so that one configuration
reads the same in both packages. The port keeps its own copy because it
imports nothing of the JAX package.

`k_max` is the static upper bound on the number of clusters: clustering
emits a fixed-size (k_max, D) token tensor plus a validity mask instead of a
variable number of tokens.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ViTConfig:
    """SigLIP-style ViT feature extractor (frozen backbone)."""

    image_size: int = 256
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    # Which hidden layer to tap features from (-1 = last, -2 = penultimate),
    # indexed like HF's hidden_states.
    select_layer: int = -1
    # 'patch' drops a class token when there is one.
    select_feature: str = "patch"
    use_class_token: bool = False
    # 2x2 token merge after this block index (None = off): a space-to-depth
    # fold and a linear projection, so the later blocks and the tokenizer
    # run at N/4. merge_pool_init starts the projection as the exact 2x2
    # average pool (0.25·[I;I;I;I], zero bias).
    merge_layer: Optional[int] = None
    merge_pool_init: bool = True

    def __post_init__(self):
        if self.merge_layer is not None:
            if not 0 <= self.merge_layer < self.depth:
                raise ValueError(
                    f"merge_layer ({self.merge_layer}) must be in "
                    f"[0, depth={self.depth})")
            if self.grid % 2 != 0:
                raise ValueError(
                    f"merge_layer needs an even patch grid for the 2x2 fold; "
                    f"got image_size={self.image_size} / "
                    f"patch_size={self.patch_size} → grid {self.grid}")
            if self.use_class_token:
                raise ValueError("merge_layer requires use_class_token=False "
                                 "(no grid slot for the cls token)")
            tap = (self.select_layer if self.select_layer >= 0
                   else self.depth + self.select_layer)
            if tap < self.merge_layer:
                raise ValueError(
                    f"select_layer ({self.select_layer} → block {tap}) taps "
                    f"a pre-merge block while merge_layer={self.merge_layer}")

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_output_patches(self) -> int:
        """Patch count the ViT emits: num_patches, /4 after a 2x2 merge."""
        n = self.num_patches
        return n // 4 if self.merge_layer is not None else n


@dataclass(frozen=True)
class TokenizerConfig:
    """SetokTokenizer: features → DPC-KNN clusters → concept tokens."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    hidden_dim: int = 768
    token_feat_dim: int = 768
    min_cluster_num: int = 64
    threshold: float = 0.55
    nheads: int = 2
    dim_feedforward: int = 3072
    inner_cluster_layers: int = 2
    intra_cluster_layers: int = 2
    proj_drop: float = 0.2
    attn_drop: float = 0.0
    # static upper bound on the cluster count
    k_max: int = 80
    # k of the k-NN density estimate
    knn: int = 64
    # Selects the hand-written CUDA clustering kernel
    # (kernels/cluster_dpc.py) for unmasked inputs on the card; other
    # inputs take the plain ops.clustering path.
    use_pallas_cluster: bool = True
    # Scale-invariant DPC-KNN (distances divided by their mean; off = the
    # reference semantics).
    cluster_dist_norm: bool = False

    def __post_init__(self):
        n = self.vit.num_output_patches
        for name, v in (("k_max", self.k_max), ("knn", self.knn),
                        ("min_cluster_num", self.min_cluster_num)):
            if v > n:
                raise ValueError(
                    f"{name} ({v}) exceeds the ViT's output patch count "
                    f"N={n}" + (" (after the 2x2 token merge)"
                                if self.vit.merge_layer is not None else ""))


@dataclass(frozen=True)
class DetokenizerConfig:
    """SetokDeTokenizer: concept tokens → Q-Former mapper → pixel decoder."""

    token_feat_dim: int = 768
    hidden_dim: int = 768          # Q-Former width
    patch_size: int = 16
    image_size: int = 256
    decoder_embed_dim: int = 768
    decoder_nheads: int = 16
    decoder_depth: int = 16
    mlp_ratio: float = 4.0
    mapper_layers: int = 6
    mapper_heads: int = 12
    cross_attention_freq: int = 2
    initializer_range: float = 0.02
    proj_drop: float = 0.2
    attn_drop: float = 0.2

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_mask_tokens(self) -> int:
        return self.grid * self.grid


@dataclass(frozen=True)
class GANLossConfig:
    """The stage-1 PatchGAN loss (losses/gan.py): the discriminator's input
    channels and depth, the step at which the adversarial terms start, the
    generator factor's linear warm-up end, the discriminator loss ('hinge'
    or 'vanilla'), the adaptive weight and its scale, and the factor."""

    disc_in_channels: int = 3
    disc_num_layers: int = 2
    disc_start: int = 5000
    warm_up_end: int = 200
    disc_loss: str = "hinge"
    use_adaptive_weight: bool = True
    weight: float = 1.0
    factor: float = 1.0


@dataclass(frozen=True)
class ContrastiveLossConfig:
    """The stage-1 image-text contrastive loss (losses/contrastive.py): the
    initial temperature, the multi-label branch (0 = off) with its own
    temperature unless shared, its weight, and the text embedding width."""

    contrast_temperature: float = 0.07
    multi_label: int = 0
    share_temperature: bool = False
    multi_label_loss_weight: float = 1.0
    text_embed_dim: int = 768


@dataclass(frozen=True)
class DiffLossConfig:
    """MAR diffusion head (losses/diffloss.py): the per-token denoiser's
    widths, the sampling steps, the batch tiling and the mask-rate floor."""

    target_channels: int = 768
    z_channels: int = 768
    width: int = 1024
    depth: int = 3
    num_sampling_steps: str = "100"
    diffusion_batch_mul: int = 4
    mask_ratio_min: float = 0.7
    grad_checkpointing: bool = False


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA trunk for Setokim. The defaults are Vicuna-7B's widths."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False


@dataclass(frozen=True)
class SetokimConfig:
    """The MLLM: LLaMA trunk, SeTok tokenizer/detokenizer, projectors and
    the diffusion head's configuration."""

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    detokenizer: DetokenizerConfig = field(default_factory=DetokenizerConfig)
    diffloss: DiffLossConfig = field(default_factory=DiffLossConfig)
    mm_in_projector_type: str = "mlp2x_gelu"
    mm_out_projector_type: str = "mlp2x_gelu"
    mm_use_im_start_end: bool = True
    # <target> slots a generation span expands to; must equal k_max (one
    # slot per static token). None derives it.
    target_num: Optional[int] = None

    def __post_init__(self):
        if self.target_num is None:
            object.__setattr__(self, "target_num", self.tokenizer.k_max)
        elif self.target_num != self.tokenizer.k_max:
            raise ValueError(
                f"target_num ({self.target_num}) must equal tokenizer.k_max "
                f"({self.tokenizer.k_max}): a generation span expands to one "
                "<target> slot per static token.")


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation settings of the trainers (train/stage1.py,
    train/stage2.py): AdamW, a linear warm-up then cosine decay, the
    global-norm clip (0 disables), micro-batches per update, and the
    mixed-precision policy (float32 parameters, `compute_dtype`
    activations, `remat` per trunk block). Stage-1 also reads the
    discriminator's constant learning rate and the weights of the L1,
    LPIPS and contrastive terms. `mesh` of the JAX package's copy is left
    out: the port runs on one card.
    """

    learning_rate: float = 1e-3
    disc_learning_rate: float = 1e-3
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.999
    warmup_steps: int = 100
    total_steps: int = 10000
    batch_size: int = 24
    grad_accum_steps: int = 1
    seed: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    contrastive_weight: float = 1.0
    rec_l1_weight: float = 1.0
    lpips_weight: float = 1.0


# ----------------------------------------------------------------------------
# Presets (the same values as setok_tpu.config)


def tiny_tokenizer(image_size: int = 32, patch_size: int = 8) -> TokenizerConfig:
    """Small config for unit tests (runs on the CPU in seconds)."""
    vit = ViTConfig(image_size=image_size, patch_size=patch_size, width=32,
                    depth=2, num_heads=2)
    return TokenizerConfig(vit=vit, hidden_dim=32, token_feat_dim=32,
                           min_cluster_num=4, threshold=0.55, nheads=2,
                           dim_feedforward=64, k_max=8, knn=4)


def tiny_detokenizer(image_size: int = 32, patch_size: int = 8) -> DetokenizerConfig:
    return DetokenizerConfig(token_feat_dim=32, hidden_dim=32,
                             patch_size=patch_size, image_size=image_size,
                             decoder_embed_dim=32, decoder_nheads=2,
                             decoder_depth=2, mapper_layers=2, mapper_heads=2)


def base_tokenizer() -> TokenizerConfig:
    """ViT-B/16 @256 encoder, the flagship configuration."""
    return TokenizerConfig()


def base_detokenizer() -> DetokenizerConfig:
    return DetokenizerConfig()


def so400m_vit() -> ViTConfig:
    """SigLIP so400m-patch14-384 geometry: width 1152, depth 27, 16 heads,
    MLP 4304, 729 patches, penultimate-layer tap."""
    return ViTConfig(image_size=384, patch_size=14, width=1152, depth=27,
                     num_heads=16, mlp_ratio=4304 / 1152, select_layer=-2)


def so400m_tokenizer() -> TokenizerConfig:
    return TokenizerConfig(vit=so400m_vit(), hidden_dim=4096,
                           token_feat_dim=4096, min_cluster_num=64,
                           threshold=0.5, nheads=2, dim_feedforward=4096,
                           inner_cluster_layers=2, intra_cluster_layers=2,
                           k_max=80, knn=64)


def so400m_detokenizer() -> DetokenizerConfig:
    return DetokenizerConfig(token_feat_dim=4096, hidden_dim=768,
                             patch_size=14, image_size=256,
                             decoder_embed_dim=4096, decoder_nheads=16,
                             decoder_depth=16, mapper_layers=6,
                             mapper_heads=12, cross_attention_freq=2)


def tiny_llama() -> LlamaConfig:
    return LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
                       max_seq_len=256)


def vicuna_7b() -> LlamaConfig:
    return LlamaConfig()


def tiny_setokim() -> SetokimConfig:
    tok = tiny_tokenizer()
    det = tiny_detokenizer()
    diff = DiffLossConfig(target_channels=tok.token_feat_dim,
                          z_channels=det.token_feat_dim, width=32, depth=1,
                          num_sampling_steps="4", diffusion_batch_mul=2)
    return SetokimConfig(llama=tiny_llama(), tokenizer=tok, detokenizer=det,
                         diffloss=diff, target_num=tok.k_max)


def base_setokim() -> SetokimConfig:
    """Vicuna-7B trunk + the ViT-B/16 @256 SeTok, the flagship."""
    tok = base_tokenizer()
    det = base_detokenizer()
    diff = DiffLossConfig(target_channels=tok.token_feat_dim,
                          z_channels=det.token_feat_dim, width=1024, depth=3,
                          num_sampling_steps="100")
    return SetokimConfig(llama=vicuna_7b(), tokenizer=tok, detokenizer=det,
                         diffloss=diff, target_num=tok.k_max)


def replace(cfg, **kw):
    """Functional config update (configs are frozen)."""
    return dataclasses.replace(cfg, **kw)
