"""The pieces that both reference models share: matrix products in a stated
precision, layer norm, the MLP, the sums over a graph's edges, the
relation graph, easy-edge masks, the self-adversarial loss, filtered
ranking and the Adam update. Plain PyTorch; node states are [V, B, D]."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

LAYER_NORM_EPS = 1e-5
PNA_STD_EPS = 1e-6  # PNA's variance floor under the square root
# edges a time in the sums over a graph: bounds the [edges, B, D] messages
EDGE_BLOCK = 1 << 17


def fp32_matmuls() -> None:
    """Matrix products in full fp32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to TF32's 10 mantissa bits, to nearest even, as
    the tensor cores take their operands in TF32 mode."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -0x2000).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b for 2-D operands, each product (forward and both gradients)
    taken from TF32-rounded operands with fp32 sums."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = g @ round_tf32(b).t() if ctx.needs_input_grad[0] else None
        gb = round_tf32(a).t() @ g if ctx.needs_input_grad[1] else None
        return ga, gb


class Precision:
    """How the reference computes: in ``dtype`` (float64 to judge; float32,
    the configurations' precision, for the witness), and with ``tf32`` its
    matrix products from operands rounded to TF32 (float32 only), the
    control's precision (the step below fp32 with TF32 off); with
    ``reverse_edges`` every sum over a graph's edges runs in the reverse
    order (a witness: the same sums in another sound order)."""

    def __init__(self, dtype=torch.float64, tf32: bool = False,
                 reverse_edges: bool = False):
        self.dtype = dtype
        self.tf32 = tf32
        self.reverse_edges = reverse_edges
        fp32_matmuls()  # any rounding to TF32 is this class's own

    def cast(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.dtype) for k, v in tensors.items()}

    def edges(self, edges: "Edges") -> "Edges":
        """``edges`` with their weights in ``dtype``, reversed if asked."""
        flip = (lambda t: t.flip(0)) if self.reverse_edges else (lambda t: t)
        return Edges(flip(edges.src), flip(edges.dst), flip(edges.typ),
                     flip(edges.w.to(self.dtype)), edges.num_nodes)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., k] @ b [k, n]."""
        if not self.tf32:
            return a @ b.to(a.dtype)
        lead = a.shape[:-1]
        return _Tf32Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(
            *lead, b.shape[1])

    def linear(self, x, weight, bias=None):
        y = self.mm(x, weight.t())
        return y if bias is None else y + bias

    def mlp(self, x, params: Dict[str, torch.Tensor], prefix: str,
            layers: int):
        """torchdrug's MLP: ``layers`` linears named ``{prefix}{i}``, ReLU
        between them and none after the last."""
        for i in range(layers):
            x = self.linear(x, params[f"{prefix}{i}.weight"],
                            params[f"{prefix}{i}.bias"])
            if i < layers - 1:
                x = torch.relu(x)
        return x


def layer_norm(x, weight, bias):
    return F.layer_norm(x, (x.shape[-1],), weight, bias, LAYER_NORM_EPS)


class Edges:
    """A graph's directed edges: ``src`` -> ``dst`` of type ``typ`` with
    weight ``w``, over ``num_nodes`` nodes."""

    def __init__(self, src, dst, typ, w, num_nodes: int):
        self.src, self.dst, self.typ, self.w = src, dst, typ, w
        self.num_nodes = int(num_nodes)

    @staticmethod
    def undirected(h, t, r, w, num_nodes: int, num_relations: int):
        """The fact edges (h -> t, r) and their inverses (t -> h, r + R),
        each inverse with its edge's weight."""
        return Edges(torch.cat([h, t]), torch.cat([t, h]),
                     torch.cat([r, r + num_relations]), torch.cat([w, w]),
                     num_nodes)

    def in_degree(self) -> torch.Tensor:
        """Σ of the weights of each node's in-edges, [V]."""
        return torch.zeros(self.num_nodes, dtype=self.w.dtype,
                           device=self.w.device).index_add(0, self.dst,
                                                           self.w)

    def blocks(self):
        for a in range(0, len(self.src), EDGE_BLOCK):
            yield slice(a, a + EDGE_BLOCK)


def _messages(edges: Edges, s: slice, x, rel):
    """The distmult messages rel[typ] ⊙ x[src] of the edges ``s``: [n, B, D]
    (``rel`` [T, B, D] or [T, D])."""
    r = rel[edges.typ[s]]
    if r.dim() == 2:
        r = r[:, None, :]
    return r * x[edges.src[s]]


def edge_sum(edges: Edges, x, rel):
    """Σ over each node's in-edges of w · rel[typ] ⊙ x[src]: [V, B, D]."""
    out = x.new_zeros((edges.num_nodes,) + tuple(x.shape[1:]))
    for s in edges.blocks():
        m = _messages(edges, s, x, rel) * edges.w[s, None, None]
        out = out.index_add(0, edges.dst[s], m)
    return out


class _EdgeExtremum(torch.autograd.Function):
    """The max (or min) over each node's in-edges of per-edge values
    [E, ...], 0 for a node without in-edges, differentiated as the
    published implementation's generalized rspmm (torchdrug) differentiates
    it: every edge whose value equals the extremum takes the node's whole
    gradient."""

    @staticmethod
    def forward(ctx, values, dst, num_nodes: int, reduce: str):
        fill = -math.inf if reduce == "amax" else math.inf
        out = values.new_full((num_nodes,) + tuple(values.shape[1:]), fill)
        idx = dst.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
        out = out.scatter_reduce(0, idx, values, reduce, include_self=True)
        out = torch.where(torch.isfinite(out), out, 0.0)
        ctx.save_for_backward(values, dst, out)
        return out

    @staticmethod
    def backward(ctx, g):
        values, dst, out = ctx.saved_tensors
        return torch.where(values == out[dst], g[dst], 0.0), None, None, None


def edge_stats(edges: Edges, x, rel):
    """PNA's four sums over each node's in-edges, with m = rel[typ] ⊙ x[src]:
    Σ w·m, Σ w·m², and the max and min of w·m (``_EdgeExtremum``)."""
    m = _messages(edges, slice(None), x, rel)
    mw = m * edges.w[:, None, None]
    zeros = x.new_zeros((edges.num_nodes,) + tuple(x.shape[1:]))
    s = zeros.index_add(0, edges.dst, mw)
    sq = zeros.index_add(0, edges.dst, m * mw)
    mx = _EdgeExtremum.apply(mw, edges.dst, edges.num_nodes, "amax")
    mn = _EdgeExtremum.apply(mw, edges.dst, edges.num_nodes, "amin")
    return s, sq, mx, mn


def boundary(num_nodes: int, rows: torch.Tensor, values: torch.Tensor):
    """[V, B, D] zeros with values[b] at (rows[b], b)."""
    B, D = values.shape
    out = values.new_zeros((num_nodes, B, D))
    return out.index_put((rows, torch.arange(B, device=rows.device)),
                         values, accumulate=True)


def triple_keys(h, t, r, num_nodes: int, num_relations: int):
    """One int64 key a (h, t, r) triple."""
    return (h.long() * num_nodes + t.long()) * num_relations + r.long()


def relation_adjacency(h, t, r, num_nodes: int, num_relations: int):
    """ULTRA's relation graph of the fact triples, dense: A [4, 2R, 2R] with
    A[k, b, a] = 1 where relation a -> relation b is an edge of type k.
    On the fact edges and their inverses (t, h, r + R), relations a and b
    are joined when one entity is the head of both (type 0), the tail of
    both (1), the head of a and tail of b (2), or the tail of a and head of
    b (3)."""
    R2 = 2 * num_relations
    dev = h.device
    heads = torch.zeros((num_nodes, R2), device=dev)
    tails = torch.zeros((num_nodes, R2), device=dev)
    heads[h, r] = 1.0
    heads[t, r + num_relations] = 1.0
    tails[t, r] = 1.0
    tails[h, r + num_relations] = 1.0
    # 0/1 operands and integer sums below 2^24: exact in any matmul mode
    pairs = [heads.t() @ heads, tails.t() @ tails, heads.t() @ tails,
             tails.t() @ heads]  # [a, b]: a -> b
    return torch.stack([(p.t() > 0).float() for p in pairs])


def candidates(batch: torch.Tensor, neg: torch.Tensor):
    """The (h, t, r) grids [B, 1 + N] of each query's positive and its N
    negatives: the first half of the rows corrupt the tail, the rest the
    head."""
    B, N = neg.shape
    h, t, r = (batch[:, i:i + 1].expand(B, N + 1) for i in range(3))
    tail_rows = (torch.arange(B, device=batch.device) < B // 2)[:, None]
    h = torch.where(tail_rows, h, torch.cat([batch[:, :1], neg], 1))
    t = torch.where(tail_rows, torch.cat([batch[:, 1:2], neg], 1), t)
    return h, t, r


def easy_edge_weights(fact_keys, grid_keys):
    """1 for each fact edge, 0 for those whose triple is among the batch's
    candidates (the easy edges a query could read its answer from)."""
    return (~torch.isin(fact_keys, grid_keys.reshape(-1))).float()


def tail_form(h, t, r, num_relations: int):
    """Head-corrupting rows (the second half) as tail prediction over the
    inverse relation: (t, h, r + R)."""
    head_rows = (torch.arange(h.shape[0], device=h.device)
                 >= h.shape[0] // 2)[:, None]
    return (torch.where(head_rows, t, h), torch.where(head_rows, h, t),
            torch.where(head_rows, r + num_relations, r))


def bce_adversarial_rows(scores, temperature: float):
    """Each row's binary cross entropy, column 0 the positive, with the
    negatives weighted by the softmax of their scores over ``temperature``
    (no gradient through the weights): [B]."""
    target = torch.zeros_like(scores)
    target[:, 0] = 1.0
    loss = F.binary_cross_entropy_with_logits(scores, target,
                                              reduction="none")
    neg_w = torch.softmax(scores[:, 1:].detach() / temperature, dim=-1)
    weight = torch.cat([torch.ones_like(scores[:, :1]), neg_w], dim=1)
    return (loss * weight).sum(-1) / weight.sum(-1)


def truth_masks(all_keys_sorted, batch, num_nodes: int, num_relations: int):
    """[B, V] masks of the entities that complete a known triple: tails v of
    (h, v, r) and heads v of (v, t, r), against every split's triples."""
    v = torch.arange(num_nodes, device=batch.device)[None, :]
    h, t, r = batch[:, :1], batch[:, 1:2], batch[:, 2:3]

    def known(keys):
        pos = torch.searchsorted(all_keys_sorted, keys).clamp(
            max=len(all_keys_sorted) - 1)
        return all_keys_sorted[pos] == keys

    return (known(triple_keys(h, v, r, num_nodes, num_relations)),
            known(triple_keys(v, t, r, num_nodes, num_relations)))


def filtered_rank(scores, target, truth):
    """1 + the allowed entities scoring at least the target's: [B]."""
    pos = scores.gather(1, target[:, None])
    return ((scores >= pos) & ~truth).sum(-1) + 1


class Adam:
    """Adam (``weight_decay`` 0) or AdamW (decoupled decay), betas 0.9 and
    0.999, eps 1e-8 outside the square root, bias-corrected: PyTorch's
    and optax's update rule, in fp32."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
