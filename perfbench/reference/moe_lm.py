"""Plain reference of a decoder-only mixture-of-experts LM (granite-moe).

Each layer is pre-norm: RMSNorm, causal grouped-query attention with
rotary embeddings, a residual add; RMSNorm, a top-k mixture of SwiGLU
experts, a residual add. The router is a float32 softmax over the experts;
a token's k largest probabilities, renormalised, weigh its experts. Routing
groups are sequences: an expert takes at most ceil(S k / E x
capacity_factor) (token, choice) pairs of a sequence, the earliest in
token-major order, and a pair past that is dropped (it adds nothing). The
load-balance term is E x sum_e f_e p_e over the first choices (Switch). The
loss is the mean next-token NLL over the padded vocabulary, plus z_loss x
mean(lse^2), plus router_aux_coef x the layers' summed balance terms.

In a decode step a group is one token, so no pair is dropped; the teacher-
forced ``forward_cached`` routes each token alone for that reason.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (Leaf, Numerics, attention, const, layer, layout_bytes,
                     layout_numel, lm_loss_row, normal, rms_norm, rope,
                     swiglu)


class MoELM:
    def __init__(self, cfg: Dict):
        self.cfg = cfg
        self.L = cfg["num_layers"]
        self.d = cfg["d_model"]
        self.hq, self.kv = cfg["num_heads"], cfg["num_kv_heads"]
        self.hd = cfg["head_dim"]
        self.f = cfg["d_ff"]
        self.E, self.K = cfg["num_experts"], cfg["experts_per_token"]
        self.vp = -(-cfg["vocab_size"] // 256) * 256
        self.eps = cfg["norm_eps"]

    # -- what the benchmark makes ------------------------------------------

    def param_layout(self) -> Dict:
        L, d, f, E = self.L, self.d, self.f, self.E
        qd, kd = self.hq * self.hd, self.kv * self.hd
        out_scale = 1 / math.sqrt(2 * L)
        return {
            "embed": {"tok": normal((self.vp, d), fan_in=d),
                      "out": normal((d, self.vp))},
            "final_norm": {"scale": const((d,), 1.0)},
            "moe_blocks": {
                "ln1": {"scale": const((L, d), 1.0)},
                "ln2": {"scale": const((L, d), 1.0)},
                "attn": {"wq": normal((L, d, qd)), "wk": normal((L, d, kd)),
                         "wv": normal((L, d, kd)),
                         "wo": normal((L, qd, d), scale=out_scale)},
                "ffn": {"router": normal((L, d, E), dtype=torch.float32),
                        "w_gate": normal((L, E, d, f)),
                        "w_up": normal((L, E, d, f)),
                        "w_down": normal((L, E, f, d), scale=out_scale)},
            }}

    def cache_layout(self, batch: int, slots: int) -> Dict:
        shape = (self.L, batch, self.kv, slots, self.hd)
        return {"self": {"k": Leaf(shape), "v": Leaf(shape)}}

    def counts(self) -> Dict[str, int]:
        """What the benchmark's counts of operations and bytes take from
        this family: parameters by kind (``dense``: every token uses them;
        ``experts``: all experts' weights; ``active``: what one token
        multiplies, dense plus its k experts; ``embed``: the token table,
        read a row a token; ``total``), the self-attention layers a token
        passes, a recurrence's flops a token (none here), the bytes of
        every weight but the token table, and the logits' width."""
        layout = self.param_layout()
        total = layout_numel(layout)
        embed = layout_numel({"tok": layout["embed"]["tok"]})
        ffn = layout["moe_blocks"]["ffn"]
        experts = layout_numel({k: ffn[k]
                                for k in ("w_gate", "w_up", "w_down")})
        dense = total - embed - experts
        return {"dense": dense, "experts": experts,
                "active": dense + experts * self.K // self.E,
                "embed": embed, "total": total,
                "attention_layers": self.L, "recurrence_flops_per_token": 0,
                "weight_bytes": layout_bytes(layout)
                - layout_bytes({"tok": layout["embed"]["tok"]}),
                "logit_width": self.vp}

    # -- layers -------------------------------------------------------------

    def moe(self, num: Numerics, p: Dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [G, S, D] f32 in routing groups of S tokens; returns (the
        experts' gated sum [G, S, D], the balance term)."""
        g, s, d = x.shape
        E, K = self.E, self.K
        probs = torch.softmax(x @ p["router"].float(), dim=-1)
        choice = probs.topk(K, dim=-1).indices                   # [G, S, K]
        gates = probs.gather(-1, choice)
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        first = F.one_hot(choice[..., 0], E).float().mean((0, 1))
        aux = E * (first * probs.mean((0, 1))).sum()
        cap = math.ceil(s * K / E * self.cfg["capacity_factor"])
        ids = choice.reshape(g, s * K)                            # token-major
        onehot = F.one_hot(ids, E)
        rank = (onehot.cumsum(1) - 1).gather(-1, ids[..., None])[..., 0]
        kept = (rank < cap).reshape(-1).nonzero().squeeze(1)
        expert = ids.reshape(-1)[kept]
        token = (kept // (s * K)) * s + (kept % (s * K)) // K
        gate = gates.reshape(-1)[kept]
        order = torch.argsort(expert, stable=True)
        counts = torch.bincount(expert, minlength=E).tolist()
        rows = x.reshape(g * s, d)[token[order]]
        outs = [swiglu(num, r, p["w_gate"][e].float(), p["w_up"][e].float(),
                       p["w_down"][e].float())
                for e, r in enumerate(rows.split(counts)) if r.shape[0]]
        y = torch.cat(outs) * gate[order][:, None]
        out = torch.zeros(g * s, d, device=x.device).index_add(
            0, token[order], y)
        return out.reshape(g, s, d), aux

    def qkv(self, num: Numerics, p: Dict, h: torch.Tensor,
            pos: torch.Tensor):
        b, s, _ = h.shape
        q = num.mm(h, p["wq"].float()).reshape(b, s, self.hq, self.hd)
        k = num.mm(h, p["wk"].float()).reshape(b, s, self.kv, self.hd)
        v = num.mm(h, p["wv"].float()).reshape(b, s, self.kv, self.hd)
        theta = self.cfg["rope_theta"]
        return rope(q, pos, theta), rope(k, pos, theta), v

    def block(self, num: Numerics, p: Dict, x: torch.Tensor,
              pos: torch.Tensor, prefix: Optional[Tuple] = None,
              token_groups: bool = False):
        """One layer over x [B, S, D] at positions pos [S]. ``prefix``:
        (k, v) [B, KV, P, hd] of the positions before pos[0], read as
        stored. Returns (x, aux, k, v) with this layer's new k, v [B, S,
        KV, hd]."""
        b, s, d = x.shape
        q, k, v = self.qkv(num, p["attn"],
                           rms_norm(x, p["ln1"]["scale"], self.eps), pos)
        kk, vv, kpos = k, v, pos
        if prefix is not None:
            pk, pv = (t.float().transpose(1, 2) for t in prefix)
            kk, vv = torch.cat([pk, k], 1), torch.cat([pv, v], 1)
            kpos = torch.cat([torch.arange(pk.shape[1], device=x.device),
                              pos])
        a = attention(num, q, kk, vv, pos, kpos).reshape(b, s, -1)
        x = x + num.mm(a, p["attn"]["wo"].float())
        h = rms_norm(x, p["ln2"]["scale"], self.eps)
        if token_groups:
            m, aux = self.moe(num, p["ffn"], h.reshape(b * s, 1, d))
            m = m.reshape(b, s, d)
        else:
            m, aux = self.moe(num, p["ffn"], h)
        return x + m, aux, k, v

    # -- training -----------------------------------------------------------

    def loss(self, num: Numerics, params: Dict, tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """The training loss of a batch [B, S]; each layer and each row's
        logits recomputed in backward, so that the float32 activations of
        one layer live at a time."""
        cfg = self.cfg
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device)
        x = F.embedding(tokens, params["embed"]["tok"]).float()
        aux = x.new_zeros(())
        blocks = params["moe_blocks"]

        def run(i, x):
            y, a, _, _ = self.block(num, layer(blocks, i), x, pos)
            return y, a

        for i in range(self.L):
            x, a = checkpoint(run, i, x, use_reentrant=False)
            aux = aux + a
        total = x.new_zeros(())
        for r in range(b):
            total = total + checkpoint(
                lm_loss_row, num, x[r], params["final_norm"]["scale"],
                params["embed"]["out"], labels[r], self.eps, cfg["z_loss"],
                use_reentrant=False)
        return total / (b * s) + cfg["router_aux_coef"] * aux

    # -- serving ------------------------------------------------------------

    def flat_cache(self, cache: Dict) -> Dict:
        """The program's cache tree by the names ``forward_cached`` uses."""
        return {"k": cache["self"]["k"], "v": cache["self"]["v"]}

    @torch.no_grad()
    def forward_cached(self, num: Numerics, params: Dict,
                       tokens: torch.Tensor, cache: Dict,
                       last_only: bool = False, token_groups: bool = True
                       ) -> Tuple[torch.Tensor, Dict]:
        """Teacher-forced decode: tokens [B, n] fed one after another from
        position P on, against the stored keys and values of positions
        0..P-1 (``cache["k"]``, ``cache["v"]`` [L, B, KV, P, hd]); each
        token is its own routing group, as in a decode step (a prefill
        routes each row's n tokens as one group: ``token_groups=False``).
        Returns
        (logits [B, n, V] f32, or of the last position alone with
        ``last_only``; {"k", "v": [L, B, KV, n, hd]}, the keys and values
        written)."""
        b, n = tokens.shape
        p0 = cache["k"].shape[3]
        pos = torch.arange(p0, p0 + n, device=tokens.device)
        x = F.embedding(tokens, params["embed"]["tok"]).float()
        ks, vs = [], []
        for i in range(self.L):
            x, _, k, v = self.block(num, layer(params["moe_blocks"], i), x,
                                    pos, (cache["k"][i], cache["v"][i]),
                                    token_groups=token_groups)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        if last_only:
            x = x[:, -1:]
        logits = num.mm(rms_norm(x, params["final_norm"]["scale"], self.eps),
                        params["embed"]["out"].float())
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
