"""Matcha-TTS flow-matching estimator: a 1-D UNet with transformer blocks.

Counterpart of ``viet_tts_tpu/models/matcha/decoder.py``: the sinusoidal
time embedding and its SiLU MLP, down / mid / up stages of a
GroupNorm(8) + Mish ResNet block and attention blocks, a stride-2 conv
down and a transposed conv up, skip concatenation, a final block and
projection. The UNet's interface is channel-last, (B, T, C), as the JAX
module's; inside, the conv blocks run channel-first as the reference
does, and each attention block sees (B, T, C).

Parameter names follow the reference torch model as
``train/torch_import.py:_unet_decoder_params`` reads them:
``time_mlp.linear_{1,2}``, ``down_blocks.{i}.0`` (ResNet block:
``block1.block.0`` conv, ``block1.block.1`` GroupNorm, ``mlp.1``,
``res_conv``), ``down_blocks.{i}.1.{j}`` (attention blocks: ``norm1``,
``attn1.to_q`` / ``to_k`` / ``to_v`` / ``to_out.0``, ``norm3``,
``ff.net.0.proj`` / ``alpha`` / ``beta``, ``ff.net.2``),
``down_blocks.{i}.2`` (``.conv`` for a stride-2 down, a plain conv on the
last stage), ``mid_blocks.{i}.{0,1}``, ``up_blocks.{i}.{0,1,2}`` (``.conv``
a ``ConvTranspose1d`` but on the last stage), ``final_block``,
``final_proj``. ``ConformerBlock`` (a stage's ``*_block_type:
conformer``) has no reference counterpart and keeps flax's names.

Three details are copied on purpose: ``Block1D``'s GroupNorm normalises
over the padded frames too (the mask is applied after it); the
transformer block ADDS the 0/1 validity mask to the logits (diffusers
semantics: a padded key gets a -1 handicap, not -inf), while the
conformer block masks with -1e9; flax's norms take eps 1e-6. The JAX
``remat`` flag is a memory option of the JAX package and is not read.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

MASK_NEG = -1.0e9
FLAX_EPS = 1e-6  # flax's LayerNorm / GroupNorm epsilon


def sinusoidal_time_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """(B,) -> (B, dim): [sin | cos] of scale * t at frequencies
    exp(-i log(10000) / (dim / 2 - 1))."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    ang = scale * t[:, None] * freq[None, :].to(t.dtype)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class Block1D(nn.Module):
    """conv(k=3) -> GroupNorm -> Mish on (B, C, T), masked after."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(nn.Conv1d(dim, dim_out, 3, padding=1),
                                   nn.GroupNorm(groups, dim_out, eps=FLAX_EPS), nn.Mish())

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T); mask: (B, 1, T)."""
        return self.block(x * mask) * mask


class ResnetBlock1D(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(nn.Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block1D(dim, dim_out, groups)
        self.block2 = Block1D(dim_out, dim_out, groups)
        self.res_conv = nn.Conv1d(dim, dim_out, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                time_emb: torch.Tensor) -> torch.Tensor:
        h = self.block1(x, mask) + self.mlp(time_emb)[:, :, None]
        return self.block2(h, mask) + self.res_conv(x * mask)


class SnakeBeta(nn.Module):
    """The feed-forward's input projection and the snakebeta activation
    x + sin^2(x * e^alpha) / (e^beta + 1e-9) (log-scale alpha / beta,
    seeded at 0)."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim)
        self.alpha = nn.Parameter(torch.zeros(inner_dim))
        self.beta = nn.Parameter(torch.zeros(inner_dim))

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.zero_()
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj(x)
        alpha, beta = torch.exp(self.alpha), torch.exp(self.beta)
        return h + (1.0 / (beta + 1e-9)) * torch.sin(h * alpha) ** 2


class SnakeBetaFF(nn.Module):
    """snakebeta projection -> dropout -> projection (``net.0`` / ``net.2``)."""

    def __init__(self, dim: int, inner_dim: int, dim_out: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(SnakeBeta(dim, inner_dim), nn.Dropout(dropout),
                                 nn.Linear(inner_dim, dim_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Attention(nn.Module):
    """diffusers' self-attention of the block: bias-free Q / K / V, an
    output projection (``to_out.0``; diffusers' ``to_out.1`` is a dropout
    that the JAX block does not apply)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, dropout: float = 0.0):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])
        self.drop = nn.Dropout(dropout)

    def forward(self, h: torch.Tensor, valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, _ = h.shape
        H, D = self.num_heads, self.head_dim

        def heads(z):
            return z.reshape(B, T, H, D).transpose(1, 2)  # (B, H, T, D)

        q, k, v = heads(self.to_q(h)), heads(self.to_k(h)), heads(self.to_v(h))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
        if valid_mask is not None:
            # ADDED, as diffusers adds a float mask: padded keys get -1
            scores = scores + valid_mask.to(scores.dtype)[:, None, None, :]
        attn = self.drop(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, H * D)
        return self.to_out[0](ctx)


class BasicTransformerBlock(nn.Module):
    """Pre-norm self-attention and snakebeta feed-forward on (B, T, dim)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, dropout: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=FLAX_EPS)
        self.attn1 = Attention(dim, num_heads, head_dim, dropout)
        self.norm3 = nn.LayerNorm(dim, eps=FLAX_EPS)
        self.ff = SnakeBetaFF(dim, dim * 4, dim, dropout)

    def forward(self, x: torch.Tensor, valid_mask: Optional[torch.Tensor] = None):
        x = x + self.attn1(self.norm1(x), valid_mask)
        return x + self.ff(self.norm3(x))


class ConformerBlock(nn.Module):
    """Half-step FF -> self-attention with a clipped relative-position bias
    (Shaw; one table shared by the heads) -> conv module (GLU, depthwise
    conv, LayerNorm where the torch original has a BatchNorm, SiLU) ->
    half-step FF -> LayerNorm, on (B, T, dim). flax's names."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, dropout: float = 0.0,
                 ff_mult: int = 1, conv_expansion: int = 2, conv_kernel_size: int = 31,
                 max_rel_pos: int = 512):
        super().__init__()
        inner = num_heads * head_dim
        conv_dim = dim * conv_expansion
        self.num_heads, self.head_dim, self.max_rel_pos = num_heads, head_dim, max_rel_pos
        for name in ("ff1", "ff2"):
            setattr(self, f"{name}_norm", nn.LayerNorm(dim, eps=FLAX_EPS))
            setattr(self, f"{name}_in", nn.Linear(dim, dim * ff_mult))
            setattr(self, f"{name}_out", nn.Linear(dim * ff_mult, dim))
        self.attn_norm = nn.LayerNorm(dim, eps=FLAX_EPS)
        self.attn_q = nn.Linear(dim, inner)
        self.attn_k = nn.Linear(dim, inner)
        self.attn_v = nn.Linear(dim, inner)
        self.rel_pos_emb = nn.Parameter(torch.zeros(2 * max_rel_pos + 1, head_dim))
        self.attn_out = nn.Linear(inner, dim)
        self.conv_norm = nn.LayerNorm(dim, eps=FLAX_EPS)
        self.conv_in = nn.Linear(dim, 2 * conv_dim)
        self.conv_dw = nn.Conv1d(conv_dim, conv_dim, conv_kernel_size,
                                 padding=conv_kernel_size // 2, groups=conv_dim)
        self.conv_bn = nn.LayerNorm(conv_dim, eps=FLAX_EPS)
        self.conv_out = nn.Linear(conv_dim, dim)
        self.final_norm = nn.LayerNorm(dim, eps=FLAX_EPS)
        self.drop = nn.Dropout(dropout)

    def seeded_init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.rel_pos_emb.copy_(0.02 * torch.randn(self.rel_pos_emb.shape,
                                                      generator=generator))

    def _ff(self, h: torch.Tensor, name: str) -> torch.Tensor:
        h = getattr(self, f"{name}_norm")(h)
        h = self.drop(F.silu(getattr(self, f"{name}_in")(h)))
        return self.drop(getattr(self, f"{name}_out")(h))

    def forward(self, x: torch.Tensor, valid_mask: Optional[torch.Tensor] = None):
        B, T, _ = x.shape
        H, D = self.num_heads, self.head_dim
        mask = (torch.ones_like(x[..., :1]) if valid_mask is None
                else valid_mask[..., None].to(x.dtype))
        x = x + 0.5 * self._ff(x, "ff1")

        h = self.attn_norm(x)
        q = self.attn_q(h).reshape(B, T, H, D).transpose(1, 2)  # (B, H, T, D)
        k = self.attn_k(h).reshape(B, T, H, D).transpose(1, 2)
        v = self.attn_v(h).reshape(B, T, H, D).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2))
        pos = torch.arange(T, device=x.device)
        rel = torch.clamp(pos[None, :] - pos[:, None], -self.max_rel_pos,
                          self.max_rel_pos) + self.max_rel_pos  # (T, T)
        # q . rel_emb[rel[i, j]]: the products with every table row, gathered
        q_rel = torch.matmul(q, self.rel_pos_emb.t())  # (B, H, T, 2M + 1)
        scores = scores + torch.gather(q_rel, 3, rel[None, None].expand(B, H, T, T))
        scores = scores / math.sqrt(D)
        if valid_mask is not None:
            scores = scores.masked_fill(~valid_mask[:, None, None, :], MASK_NEG)
        attn = self.drop(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, H * D)
        x = x + self.drop(self.attn_out(ctx))

        h = self.conv_in(self.conv_norm(x))
        a, b = h.chunk(2, dim=-1)
        h = (a * torch.sigmoid(b)) * mask
        h = self.conv_dw(h.transpose(1, 2)).transpose(1, 2)
        h = self.conv_out(F.silu(self.conv_bn(h)))
        x = x + self.drop(h)

        x = x + 0.5 * self._ff(x, "ff2")
        return self.final_norm(x)


class Downsample1D(nn.Module):
    """Conv1d k=3, stride 2, padding 1 (``.conv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1D(nn.Module):
    """ConvTranspose1d k=4, stride 2, padding 1 (``.conv``): T -> 2T."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim_out, 4, stride=2, padding=1)

    def seeded_init_(self, generator: torch.Generator) -> None:
        w = self.conv.weight  # (in, out, k): torch's fan_in is out * k
        bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2])
        with torch.no_grad():
            w.copy_((torch.rand(w.shape, generator=generator) * 2.0 - 1.0) * bound)
            self.conv.bias.copy_((torch.rand(self.conv.bias.shape, generator=generator)
                                  * 2.0 - 1.0) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNetDecoder(nn.Module):
    """The CFM vector-field estimator: x (B, T, in_channels - n_feats -
    spk_dim) noisy sample, mask (B, T, 1), mu (B, T, n_feats), t (B,), spks
    (B, spk_dim) -> (B, T, out_channels). T must be a multiple of
    2^(len(channels) - 1)."""

    def __init__(self, in_channels: int, out_channels: int, channels: Sequence[int] = (256, 256),
                 dropout: float = 0.05, attention_head_dim: int = 64, n_blocks: int = 1,
                 num_mid_blocks: int = 2, num_heads: int = 2,
                 down_block_type: str = "transformer", mid_block_type: str = "transformer",
                 up_block_type: str = "transformer"):
        super().__init__()
        channels = tuple(channels)
        self.in_channels = in_channels
        time_dim = channels[0] * 4
        self.time_mlp = TimestepEmbedding(in_channels, time_dim)

        def blocks(kind: str, dim: int) -> nn.ModuleList:
            cls = ConformerBlock if kind == "conformer" else BasicTransformerBlock
            return nn.ModuleList(cls(dim, num_heads, attention_head_dim, dropout)
                                 for _ in range(n_blocks))

        self.down_blocks = nn.ModuleList()
        ch_in = in_channels
        for i, ch in enumerate(channels):
            last = i == len(channels) - 1
            down = nn.Conv1d(ch, ch, 3, padding=1) if last else Downsample1D(ch)
            self.down_blocks.append(nn.ModuleList([
                ResnetBlock1D(ch_in, ch, time_dim), blocks(down_block_type, ch), down]))
            ch_in = ch
        self.mid_blocks = nn.ModuleList(
            nn.ModuleList([ResnetBlock1D(channels[-1], channels[-1], time_dim),
                           blocks(mid_block_type, channels[-1])])
            for _ in range(num_mid_blocks))
        up_channels = channels[::-1] + (channels[0],)
        self.up_blocks = nn.ModuleList()
        h_ch = channels[-1]
        for i in range(len(up_channels) - 1):
            out_ch = up_channels[i + 1]
            last = i == len(up_channels) - 2
            skip = channels[len(channels) - 1 - i]
            up = nn.Conv1d(out_ch, out_ch, 3, padding=1) if last else Upsample1D(out_ch, out_ch)
            self.up_blocks.append(nn.ModuleList([
                ResnetBlock1D(h_ch + skip, out_ch, time_dim), blocks(up_block_type, out_ch), up]))
            h_ch = out_ch
        self.final_block = Block1D(up_channels[-1], up_channels[-1])
        self.final_proj = nn.Conv1d(up_channels[-1], out_channels, 1)

    @staticmethod
    def _attend(tf_blocks: nn.ModuleList, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The stage's attention blocks on channel-first h (B, C, T)."""
        if not len(tf_blocks):
            return h
        valid = mask[:, 0] > 0
        h = h.transpose(1, 2)
        for block in tf_blocks:
            h = block(h, valid)
        return h.transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor, t: torch.Tensor,
                spks: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = [x, mu]
        if spks is not None:
            h.append(spks[:, None, :].expand(-1, x.shape[1], -1).to(x.dtype))
        h = torch.cat(h, dim=-1)
        t_emb = self.time_mlp(sinusoidal_time_embedding(t.to(x.dtype), h.shape[-1]))
        h = h.transpose(1, 2)  # (B, C, T)
        mask_cf = mask.transpose(1, 2)  # (B, 1, T)

        hiddens = []
        masks = [mask_cf]
        for i, (resnet, tf_blocks, down) in enumerate(self.down_blocks):
            m = masks[-1]
            h = self._attend(tf_blocks, resnet(h, m, t_emb), m)
            hiddens.append(h)
            h = down(h * m)
            masks.append(m if i == len(self.down_blocks) - 1 else m[:, :, ::2])

        masks = masks[:-1]
        m_mid = masks[-1]
        for resnet, tf_blocks in self.mid_blocks:
            h = self._attend(tf_blocks, resnet(h, m_mid, t_emb), m_mid)

        for resnet, tf_blocks, up in self.up_blocks:
            m = masks.pop()
            h = torch.cat([h, hiddens.pop()], dim=1)
            h = self._attend(tf_blocks, resnet(h, m, t_emb), m)
            h = up(h * m)

        h = self.final_block(h, mask_cf)
        out = self.final_proj(h * mask_cf) * mask_cf
        return out.transpose(1, 2)
