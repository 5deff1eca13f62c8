"""Plain float32 PyTorch of the dense decoders the benchmark runs.

A Llama-family decoder as Mistral-NeMo-Base-2407 and SmolLM-135M publish
it: token embedding; per layer RMSNorm, grouped-query attention with
rotary positions (the rotate-half convention, base ``rope_theta``),
RMSNorm, a SwiGLU MLP (``silu(h W_gate) * (h W_in) W_out``); a final
RMSNorm and the head (the embedding's transpose where it is tied). No
kernel, cache layout or batching of the program is used: every product
is a plain f32 matmul with TF32 off (``no_tf32``).

It reads the configuration's published keys (``hidden_size`` ...) and a
weight tree keyed as the benchmark makes it (``embed``, ``head``,
``final_norm.scale``, ``stack[i].attn.wq`` ...); it imports nothing of
the program. ``fp8`` computes every weight product of a layer and the
head in float8 (e4m3): the matrix with one scale per output column, its
input with one scale per row; the lower-precision control of the
checks.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

MATRICES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate",
            "mlp.w_in", "mlp.w_out")


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls in f32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_fp8(w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``w`` through float8 e4m3 with one scale per slice along ``dim``
    (0: per output column of a (d_in, d_out) matrix; -1: per row of an
    input), back in f32."""
    w = w.float()
    s = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


def dims(cfg: Dict) -> Dict[str, float]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, h=h, kv=cfg["num_key_value_heads"],
                hd=cfg.get("head_dim") or d // h,
                theta=float(cfg["rope_theta"]),
                eps=float(cfg["rms_norm_eps"]),
                tied=bool(cfg.get("tie_word_embeddings", False)))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), positions (S,): rotate-half rotary embedding."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv  # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer_weights(layer: Dict, fp8: bool = False) -> Dict:
    """One layer's weights in f32 (``fp8``: through float8 e4m3)."""
    out = {"attn_norm": layer["attn_norm"]["scale"].float(),
           "mlp_norm": layer["mlp_norm"]["scale"].float()}
    for name in MATRICES:
        group, key = name.split(".")
        w = layer[group][key]
        out[key] = to_fp8(w) if fp8 else w.float()
    return out


def attention(q, k, v, q_pos, k_pos, group: int) -> torch.Tensor:
    """Causal softmax attention, f32. q (Sq, H, D); k, v (Sk, KV, D);
    query head j reads KV head j // group. One KV head's queries at a
    time, so the scores held are (group, Sq, Sk)."""
    Sq, H, D = q.shape
    out = torch.empty_like(q)
    mask = q_pos[:, None] >= k_pos[None, :]
    for j in range(k.shape[1]):
        qs = q[:, j * group:(j + 1) * group].transpose(0, 1)  # (g, Sq, D)
        s = qs @ k[:, j].T * D ** -0.5  # (g, Sq, Sk)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[:, j * group:(j + 1) * group] = (p @ v[:, j]).transpose(0, 1)
    return out


def layer_forward(w: Dict, x: torch.Tensor, pos: torch.Tensor, dm: Dict,
                  cache: Optional[List[torch.Tensor]] = None,
                  aq=None) -> torch.Tensor:
    """One decoder layer over one sequence x (S, d) at positions ``pos``.
    ``cache`` ([K, V] of the earlier positions, or empty) grows by this
    call's rows: prefill and decode through a plain cache. ``aq``, where
    given, maps the input of every weight product (the control's
    quantization)."""
    aq = aq or (lambda a: a)
    S = x.shape[0]
    h = aq(rmsnorm(x, w["attn_norm"], dm["eps"]))
    q = rope((h @ w["wq"]).view(S, dm["h"], dm["hd"]), pos, dm["theta"])
    k = rope((h @ w["wk"]).view(S, dm["kv"], dm["hd"]), pos, dm["theta"])
    v = (h @ w["wv"]).view(S, dm["kv"], dm["hd"])
    k_pos = pos
    if cache is not None:
        if cache:
            k = torch.cat([cache[0], k])
            v = torch.cat([cache[1], v])
            k_pos = torch.cat([cache[2], pos])
        cache[:] = [k, v, k_pos]
    o = attention(q, k, v, pos, k_pos, dm["h"] // dm["kv"])
    x = x + aq(o.reshape(S, -1)) @ w["wo"]
    h = aq(rmsnorm(x, w["mlp_norm"], dm["eps"]))
    return x + aq(F.silu(h @ w["w_gate"]) * (h @ w["w_in"])) @ w["w_out"]


def head_matrix(params: Dict, dm: Dict, fp8: bool = False) -> torch.Tensor:
    head = params["embed"].T if dm["tied"] else params["head"]
    return to_fp8(head) if fp8 else head.float()


def logits_at(params: Dict, cfg: Dict, seqs: Sequence[torch.Tensor],
              rows: Sequence[torch.Tensor], fp8: bool = False
              ) -> List[torch.Tensor]:
    """Full forward of each token sequence (1-D ids) from position 0,
    layer by layer over all sequences (one layer's f32 weights live at a
    time); returns each sequence's f32 logits at its ``rows``."""
    dm = dims(cfg)
    aq = (lambda a: to_fp8(a, dim=-1)) if fp8 else None
    xs = [params["embed"][s.long()].float() for s in seqs]
    pos = [torch.arange(s.numel(), device=s.device) for s in seqs]
    with no_tf32():
        for layer in params["stack"]:
            w = layer_weights(layer, fp8)
            xs = [layer_forward(w, x, p, dm, aq=aq)
                  for x, p in zip(xs, pos)]
            del w
        head = head_matrix(params, dm, fp8)
        norm = params["final_norm"]["scale"].float()
        aq = aq or (lambda a: a)
        return [aq(rmsnorm(x[r.long()], norm, dm["eps"])) @ head
                for x, r in zip(xs, rows)]


def decode_greedy(params: Dict, cfg: Dict, prompt: torch.Tensor, steps: int
                  ) -> List[int]:
    """Prefill ``prompt`` then decode ``steps`` greedy tokens through a
    plain per-layer cache (the reference's serving path)."""
    dm = dims(cfg)
    ws = [layer_weights(layer) for layer in params["stack"]]
    caches: List[List[torch.Tensor]] = [[] for _ in ws]
    head = head_matrix(params, dm)
    norm = params["final_norm"]["scale"].float()
    toks = prompt.long()
    start, out = 0, []
    with no_tf32():
        for _ in range(steps):
            x = params["embed"][toks].float()
            pos = torch.arange(start, start + toks.numel(),
                               device=toks.device)
            for w, c in zip(ws, caches):
                x = layer_forward(w, x, pos, dm, cache=c)
            nxt = int(torch.argmax(rmsnorm(x[-1], norm, dm["eps"]) @ head))
            out.append(nxt)
            start += toks.numel()
            toks = torch.tensor([nxt], device=prompt.device)
    return out


def loss_sum(params: Dict, cfg: Dict, tokens: torch.Tensor,
             fp8: bool = False) -> torch.Tensor:
    """Summed next-token cross-entropy of ``tokens`` (b, S) over its b x
    (S - 1) predicted positions, f32, differentiable in ``params``
    (leaves that require grad); the caller divides by the batch's
    positions and runs one backward per row, so a row's activations
    are all that is held. ``fp8`` fake-quantizes every
    weight product's matrix and input to float8 e4m3 in the forward,
    with a straight-through gradient."""
    dm = dims(cfg)

    def mat(w):
        w = w.float()
        return w + (to_fp8(w) - w).detach() if fp8 else w

    def aq(a):
        return a + (to_fp8(a, dim=-1) - a).detach() if fp8 else a

    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    total = torch.zeros((), device=tokens.device)
    head_w = params["embed"].T if dm["tied"] else params["head"]
    for row in tokens:
        x = params["embed"].float()[row.long()]
        for layer in params["stack"]:
            w = {"attn_norm": layer["attn_norm"]["scale"].float(),
                 "mlp_norm": layer["mlp_norm"]["scale"].float()}
            for name in MATRICES:
                group, key = name.split(".")
                w[key] = mat(layer[group][key])
            x = layer_forward(w, x, pos, dm, aq=aq)
        x = aq(rmsnorm(x, params["final_norm"]["scale"].float(), dm["eps"]))
        total = total + F.cross_entropy(x[:-1] @ mat(head_w),
                                        row[1:].long(), reduction="sum")
    return total
