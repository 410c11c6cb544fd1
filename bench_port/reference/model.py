"""The plain reference: the InternVL-2-shaped model in float32 PyTorch.

Plain tensor operations over a dict of weights named as in
`model.weight_spec`: InternViT-style encoder (pre-norm LayerNorm blocks,
learned positions, class token), a pixel shuffle of 0.5 and the MLP
projector, and an InternLM2-style decoder (RMSNorm, RoPE on split
halves, grouped-query attention, SwiGLU). The equations are the port's
(tanh GELU, no layer scale; see the configuration's `assumed` list).
Attention is the textbook softmax over explicit scores; causal attention
is computed one packed segment at a time. No kernel, cache or batching of
the program is used, and nothing of the program is imported.

Matrix products run in float32 with TF32 off (`strict_float32`), unless
the caller passes another `dtype` (the control runs the same code in a
lower precision).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def layer_norm(x, w, b, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (((xf - mean) * torch.rsqrt(var + eps)) * w.float()
            + b.float()).to(x.dtype)


def rms_norm(x, w, eps):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * w.float()).to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def softmax_attention(q, k, v, mask=None):
    """q `[H, S, hd]`, k/v `[H, S, hd]`; `mask` `[S, S]` True = admitted."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return torch.matmul(torch.softmax(s.float(), dim=-1).to(v.dtype), v)


class Reference:
    """Forward passes over weights `w` (a dict of tensors; trainable ones
    may require grad). `d` is `model.dims(cfg)`."""

    def __init__(self, w: dict, d: dict, dtype=torch.float32):
        self.w, self.d, self.dtype = w, d, dtype

    def p(self, name):
        t = self.w[name]
        return t if "norm" in name else t.to(self.dtype)

    # -- vision ---------------------------------------------------------
    def vit_block(self, i, x):
        d, p = self.d, self.p
        b = f"vision.blocks.{i}."
        n, t, dv = x.shape
        hh, hd = d["v_heads"], dv // d["v_heads"]
        h = layer_norm(x, p(b + "norm1.weight"), p(b + "norm1.bias"),
                       d["v_eps"])
        qkv = F.linear(h, p(b + "qkv.weight"), p(b + "qkv.bias"))
        qkv = qkv.view(n, t, 3, hh, hd).permute(2, 0, 3, 1, 4)
        att = torch.stack([softmax_attention(qkv[0, j], qkv[1, j], qkv[2, j])
                           for j in range(n)])
        att = att.transpose(1, 2).reshape(n, t, dv)
        x = x + F.linear(att, p(b + "proj.weight"), p(b + "proj.bias"))
        h = layer_norm(x, p(b + "norm2.weight"), p(b + "norm2.bias"),
                       d["v_eps"])
        return x + F.linear(gelu(F.linear(h, p(b + "fc1.weight"),
                                          p(b + "fc1.bias"))),
                            p(b + "fc2.weight"), p(b + "fc2.bias"))

    def encode_tiles(self, tiles, remat=False):
        """Normalized tiles `[N, H, W, 3]` -> projected features
        `[N * tokens_per_tile, hidden]`."""
        d, p = self.d, self.p
        x = F.conv2d(tiles.to(self.dtype).permute(0, 3, 1, 2),
                     p("vision.patch_embed.weight"),
                     p("vision.patch_embed.bias"), stride=d["patch"])
        x = x.flatten(2).transpose(1, 2)
        n = x.shape[0]
        x = torch.cat([p("vision.cls_token").expand(n, -1, -1), x], 1)
        x = x + p("vision.pos_embed")
        for i in range(d["v_layers"]):
            x = (checkpoint(self.vit_block, i, x, use_reentrant=False)
                 if remat else self.vit_block(i, x))
        feats = x[:, 1:]
        g, f = d["grid"], d["shuffle"]
        feats = feats.reshape(n, g // f, f, g // f, f, -1)
        feats = feats.permute(0, 1, 3, 2, 4, 5).reshape(n, (g // f) ** 2, -1)
        h = layer_norm(feats, p("projector.norm.weight"),
                       p("projector.norm.bias"), 1e-6)
        h = F.linear(gelu(F.linear(h, p("projector.fc1.weight"),
                                   p("projector.fc1.bias"))),
                     p("projector.fc2.weight"), p("projector.fc2.bias"))
        return h.reshape(-1, h.shape[-1])

    # -- language model -------------------------------------------------
    def rope(self, positions):
        hd = self.d["head_dim"]
        inv = 1.0 / (self.d["theta"] ** (torch.arange(
            0, hd, 2, device=positions.device, dtype=torch.float64) / hd))
        ang = positions.double()[:, None] * inv[None, :]
        return torch.cos(ang).float(), torch.sin(ang).float()

    @staticmethod
    def rotate(x, cos, sin):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         -1).to(x.dtype)

    def llm_layer(self, i, x, cos, sin, spans):
        """x `[S, hidden]` of one row; `spans` the (start, end) of each
        segment: causal attention inside each."""
        d, p = self.d, self.p
        b = f"llm.layers.{i}."
        s = x.shape[0]
        hh, kv, hd = d["heads"], d["kv_heads"], d["head_dim"]
        h = rms_norm(x, p(b + "attn_norm.weight"), d["eps"])
        q = F.linear(h, p(b + "attn.wq.weight")).view(s, hh, hd).transpose(0, 1)
        k = F.linear(h, p(b + "attn.wk.weight")).view(s, kv, hd).transpose(0, 1)
        v = F.linear(h, p(b + "attn.wv.weight")).view(s, kv, hd).transpose(0, 1)
        q, k = self.rotate(q, cos, sin), self.rotate(k, cos, sin)
        k = k.repeat_interleave(hh // kv, dim=0)
        v = v.repeat_interleave(hh // kv, dim=0)
        outs = []
        for a, e in spans:
            n = e - a
            mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            outs.append(softmax_attention(q[:, a:e], k[:, a:e], v[:, a:e],
                                          mask))
        att = torch.cat(outs, dim=1).transpose(0, 1).reshape(s, hh * hd)
        x = x + F.linear(att, p(b + "attn.wo.weight"))
        h = rms_norm(x, p(b + "mlp_norm.weight"), d["eps"])
        return x + F.linear(F.silu(F.linear(h, p(b + "mlp.gate.weight")))
                            * F.linear(h, p(b + "mlp.up.weight")),
                            p(b + "mlp.down.weight"))

    def hidden(self, ids, vis, positions, spans, img_id, remat=False):
        """Final-normed hidden states `[S, hidden]` of one row: token
        embeddings with `vis` `[n, hidden]` in the IMG_CONTEXT slots, in
        order."""
        x = self.p("llm.embed.weight")[ids]
        slots = (ids == img_id).nonzero()[:, 0]
        if len(slots):
            x = x.index_put((slots,), vis[:len(slots)].to(x.dtype))
        cos, sin = self.rope(positions)
        for i in range(self.d["layers"]):
            x = (checkpoint(self.llm_layer, i, x, cos, sin, spans,
                            use_reentrant=False)
                 if remat else self.llm_layer(i, x, cos, sin, spans))
        return rms_norm(x, self.p("llm.final_norm.weight"), self.d["eps"])

    def logits(self, h):
        return F.linear(h, self.p("llm.lm_head.weight")).float()


def row_nll(ref: Reference, row: dict, img_id: int, remat=True):
    """Summed next-token nll and the count of supervised tokens of one
    packed row (`ids`, `labels`, `positions`, `spans`, `tiles`)."""
    vis = (ref.encode_tiles(row["tiles"], remat=remat)
           if len(row["tiles"]) else None)
    h = ref.hidden(row["ids"], vis, row["positions"], row["spans"], img_id,
                   remat=remat)
    labels = row["labels"][1:]
    keep = (labels != -100).nonzero()[:, 0]
    if not len(keep):
        return h.sum() * 0.0, 0
    logp = torch.log_softmax(ref.logits(h[:-1][keep]), dim=-1)
    nll = -logp.gather(1, labels[keep][:, None].long())[:, 0]
    return nll.sum(), len(keep)


def learning_rate(train: dict, count: int) -> float:
    """Linear warmup from 0, then cosine decay to 0 at `total_steps`."""
    lr, warm = train["learning_rate"], train["warmup_steps"]
    total = max(train["total_steps"], warm + 1)
    if count < warm:
        return lr * count / warm
    c = min(count - warm, total - warm)
    return lr * 0.5 * (1 + math.cos(math.pi * c / (total - warm)))


class AdamW:
    """clip_by_global_norm then AdamW with decoupled weight decay, the
    moments in the weights' dtype."""

    def __init__(self, params: dict, train: dict):
        self.params, self.t = params, train
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """One update; returns the clipped gradient of each leaf."""
        t = self.t
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        scale = 1.0 if norm < t["grad_clip"] else t["grad_clip"] / norm
        lr = learning_rate(t, self.count)
        self.count += 1
        bc1, bc2 = 1 - t["b1"] ** self.count, 1 - t["b2"] ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k].mul_(t["b1"]).add_(g, alpha=1 - t["b1"])
            self.v[k].mul_(t["b2"]).addcmul_(g, g, value=1 - t["b2"])
            u = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + 1e-8)
            p.sub_(lr * (u + t["weight_decay"] * p))
        return clipped
