"""Plain PyTorch reference of the two configurations: IGCN (INMO-LGCN) and
LightGCN, their BPR training step with Adam, and IGCN's representations
for serving.

Written from the published models (INMO, Wu et al., SIGIR'22; LightGCN, He
et al., SIGIR'20) and the configuration files, with no kernel, cache,
packing or padding: graphs are edge lists, products are gathers and
``index_add_``. Every function takes a ``dtype``: the reference runs in
float64; the precision control runs the same code in bfloat16.

  * Propagation: D^-1/2 A D^-1/2 of the user-item graph (degrees clamped
    to 1), the mean of layers 0..K.
  * IGCN's layer 0 (the INMO feature aggregation): a user sums its train
    items' template embeddings plus the user token, an item its users'
    plus the item token, each row scaled by (1 + template neighbours) to
    the power (alpha - 1) / 2 - 1 / 2. Nodes outside the template set
    (new since the templates were chosen) contribute nothing but
    aggregate over the templates. Training drops feature edges: each
    direction keeps the edges its seed keeps (``keepmask``) and the token
    edges drawn for the step, and rescales by 1 / (1 - p).
  * Loss: mean softplus(neg - pos) BPR; IGCN adds aux_reg times the BPR of
    the raw template embeddings scored through w; LightGCN adds l2_reg
    times the mean squared norm of the batch's ego embeddings.
  * Adam (b1 0.9, b2 0.999, eps 1e-8) with bias correction.

Nothing here imports the program.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference.keepmask import kept


@contextmanager
def no_tf32():
    """Full-precision float32 products on the card while the reference
    runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclass
class Graph:
    """The train graph as an edge list of (user, item) ids."""

    u: torch.Tensor
    i: torch.Tensor
    n_users: int
    n_items: int

    @staticmethod
    def of(users, items, n_users: int, n_items: int, device) -> "Graph":
        return Graph(torch.as_tensor(users, dtype=torch.int64).to(device),
                     torch.as_tensor(items, dtype=torch.int64).to(device),
                     n_users, n_items)

    def degrees(self, dtype):
        du = torch.bincount(self.u, minlength=self.n_users).to(dtype)
        di = torch.bincount(self.i, minlength=self.n_items).to(dtype)
        return du, di


def _sum_into(n: int, dst: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    out = rows.new_zeros((n, rows.shape[1]))
    return out.index_add(0, dst, rows)


def propagate_mean(g: Graph, x0: torch.Tensor, n_layers: int) -> torch.Tensor:
    du, di = g.degrees(x0.dtype)
    su = du.clamp_min(1.0).rsqrt()[:, None]
    si = di.clamp_min(1.0).rsqrt()[:, None]
    acc, x = x0, x0
    for _ in range(n_layers):
        xu, xi = x[: g.n_users], x[g.n_users:]
        yu = su * _sum_into(g.n_users, g.u, (si * xi)[g.i])
        yi = si * _sum_into(g.n_items, g.i, (su * xu)[g.u])
        x = torch.cat([yu, yi])
        acc = acc + x
    return acc / float(n_layers + 1)


@dataclass
class Drop:
    """One step's feature-edge dropout: the two directions' u32 seeds and
    the token edges' keeps, (n_users,) and (n_items,) bool."""

    seed_b: int
    seed_bt: int
    keep_u: torch.Tensor
    keep_i: torch.Tensor


def inductive_rep(emb: torch.Tensor, g: Graph, n_core_users: int,
                  n_core_items: int, alpha: float, p: float = 0.0,
                  drop: Optional[Drop] = None) -> torch.Tensor:
    """IGCN's layer 0 over the template table ``emb`` ((n_core_users +
    n_core_items + 2, d): template users, template items, the user token,
    the item token). Templates are the first ``n_core_*`` ids."""
    nu, ni, d = g.n_users, g.n_items, emb.shape[1]
    ncu, nci = n_core_users, n_core_items
    e_users = torch.cat([emb[:ncu], emb.new_zeros((nu - ncu, d))])
    e_items = torch.cat([emb[ncu:ncu + nci], emb.new_zeros((ni - nci, d))])
    tok_u, tok_i = emb[ncu + nci], emb[ncu + nci + 1]
    core_u, core_i = g.u < ncu, g.i < nci
    rs_u = 1.0 + torch.bincount(g.u[core_i], minlength=nu).to(emb.dtype)
    rs_i = 1.0 + torch.bincount(g.i[core_u], minlength=ni).to(emb.dtype)
    expo = (alpha - 1.0) / 2.0 - 0.5
    w_u, w_i = rs_u.pow(expo)[:, None], rs_i.pow(expo)[:, None]
    if drop is None:
        xu = _sum_into(nu, g.u, e_items[g.i]) + tok_u
        xi = _sum_into(ni, g.i, e_users[g.u]) + tok_i
        return torch.cat([w_u * xu, w_i * xi])
    kb = kept(drop.seed_b, g.u, g.i, p)
    kbt = kept(drop.seed_bt, g.u, g.i, p)
    scale = 1.0 / (1.0 - p)
    xu = (_sum_into(nu, g.u[kb], e_items[g.i[kb]])
          + drop.keep_u[:, None].to(emb.dtype) * tok_u) * scale
    xi = (_sum_into(ni, g.i[kbt], e_users[g.u[kbt]])
          + drop.keep_i[:, None].to(emb.dtype) * tok_i) * scale
    return torch.cat([w_u * xu, w_i * xi])


def _bpr(u, p, n) -> torch.Tensor:
    return F.softplus((u * n).sum(1) - (u * p).sum(1)).mean()


def igcn_loss(params: dict, g: Graph, cfg: dict, batch, aux, drop: Drop):
    """One IGCN step's loss; every node is a template (feature_ratio 1)."""
    emb, w = params["embedding"], params["w"]
    nu = g.n_users
    x0 = inductive_rep(emb, g, nu, g.n_items, 1.0, cfg["dropout"], drop)
    rep = propagate_mean(g, x0, cfg["n_layers"])
    users, pos, neg = batch
    u, p, n = rep[users], rep[nu + pos], rep[nu + neg]
    l2 = (u * u).sum(1) + (p * p).sum(1) + (n * n).sum(1)
    au, ap, an = aux
    eu = emb[au]
    aux_loss = F.softplus((eu * emb[nu + an] * w).sum(1)
                          - (eu * emb[nu + ap] * w).sum(1)).mean()
    return (_bpr(u, p, n) + cfg["l2_reg"] * l2.mean()
            + cfg["aux_reg"] * aux_loss)


def lightgcn_loss(params: dict, g: Graph, cfg: dict, batch):
    emb = params["embedding"]
    nu = g.n_users
    rep = propagate_mean(g, emb, cfg["n_layers"])
    users, pos, neg = batch
    e = (emb[users], emb[nu + pos], emb[nu + neg])
    l2 = sum((x * x).sum(1) for x in e)
    return (_bpr(rep[users], rep[nu + pos], rep[nu + neg])
            + cfg["l2_reg"] * l2.mean())


LOSSES = {"IGCN": igcn_loss, "LightGCN": lightgcn_loss}


@torch.no_grad()
def adam_(params: dict, grads: dict, state: dict, lr: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    state["t"] = t = state.get("t", 0) + 1
    for name, p in params.items():
        g = grads[name]
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        denom = (v / (1 - b2 ** t)).sqrt() + eps
        p.sub_(lr * (m / (1 - b1 ** t)) / denom)


@dataclass
class Steps:
    """What a run of the reference gives: each step's loss, the first
    step's gradient of each leaf, and each leaf's change over the steps
    (float64)."""

    losses: list
    grad1: dict
    change: dict


def follow(model: str, init: dict, g: Graph, cfg: dict, steps: list,
           dtype=torch.float64) -> Steps:
    """Train from ``init`` through ``steps`` (each the tuple of arguments
    of the model's loss after ``g`` and ``cfg``) with Adam at ``cfg``'s
    learning rate, computing in ``dtype``."""
    loss_fn = LOSSES[model]
    params = {k: v.detach().to(dtype).clone().requires_grad_()
              for k, v in init.items()}
    state: dict = {}
    losses, grad1 = [], None
    with no_tf32():
        for args in steps:
            loss = loss_fn(params, g, cfg, *args)
            names = list(params)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            grads = dict(zip(names, grads))
            losses.append(float(loss.detach().double()))
            if grad1 is None:
                grad1 = {n: gr.detach().double() for n, gr in grads.items()}
            adam_(params, grads, state, cfg["lr"])
    change = {n: p.detach().double() - init[n].detach().double()
              for n, p in params.items()}
    return Steps(losses, grad1, change)


# -- serving ------------------------------------------------------------------


@torch.no_grad()
def igcn_serving_reps(emb: torch.Tensor, g: Graph, n_core_users: int,
                      n_core_items: int, n_layers: int,
                      dtype=torch.float64) -> tuple:
    """(users, items) representations of the grown catalog ``g`` at alpha
    1 (no training has annealed it), templates the first ``n_core_*``."""
    with no_tf32():
        x0 = inductive_rep(emb.to(dtype), g, n_core_users, n_core_items, 1.0)
        rep = propagate_mean(g, x0, n_layers)
    return rep[: g.n_users], rep[g.n_users:]


@torch.no_grad()
def top_k(users_rep: torch.Tensor, items_rep: torch.Tensor,
          excluded: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k item ids of each user row by dot product in the reps' dtype,
    never an item of ``excluded`` ((n, n_items) bool)."""
    with no_tf32():
        s = users_rep @ items_rep.T
    s = s.masked_fill(excluded, float("-inf"))
    return torch.topk(s.float(), k, dim=1).indices
