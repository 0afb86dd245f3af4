"""Plain PyTorch reference of NGCF (Neural Graph Collaborative Filtering,
Wang et al., SIGIR'19, arXiv:1905.08108) as ``ngcf_gowalla`` trains it:
the forward, the BPR loss, autograd's gradients and Adam with bias
correction.

Written from the paper's equations and the reference project's
``model.py:233-302`` (https://github.com/WuYunfan/igcn_cf), with no
kernel, packing or padding: the graph is an edge list and each message a
gather and ``index_add_``. Every function takes a ``dtype``: the
reference runs in float64 with TF32 off; the precision control runs the
same code in bfloat16.

Over all n_users + n_items nodes, from x_0 = the embedding table, each
layer l = 1..L computes

    m0  = ((A + I) x_{l-1}) / (deg + 1)         the message, a row's
                                                neighbours and itself
    h   = leaky_relu(m0 W1 + b1 + (x_{l-1} * m0) W2 + b2, 0.2)
    x_l = dropout(h)                            kept entries / (1 - p)
    e_l = x_l / max(||x_l||, 1e-12)             by row

and the representation is the concat [x_0, e_1, ..., e_L]. The loss is
mean softplus(neg - pos) over the batch's (user, positive, negative)
triples scored by dot products of their representations, plus l2_reg
times the mean of the three rows' squared norms (the propagated rows, as
the project takes them). Weights are stored (in, out) and applied as
``x @ w + b``: ``nn.Linear``'s x W^T + b with W = w^T. Adam: b1 0.9, b2
0.999, eps 1e-8.

Departures from the paper, each the project's or the configuration's:

  * The message is (A + I) x / (deg + 1), the adjacency with self-loops
    normalised by its rows, where the paper propagates with the symmetric
    Laplacian D^-1/2 A D^-1/2 and adds the self-connection apart; the
    bi-interaction is x * m0, the self-loop inside m0, where the paper's
    is (L x) * x.
  * Message dropout drops edges of A + I. Each direction of the bipartite
    graph drops under its own u32 seed by the coordinate hash of
    ``keepmask``, which keeps an edge with probability 1 - round(p * 256)
    / 256 (p quantised to 1/256); the kept sum, self-loop included, is
    rescaled by the unquantised 1 / (1 - p) before the degree division.
  * One edge drop serves every layer of a step, where the paper draws
    message dropout anew in each layer.

Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference.gcn import Graph, Steps, _sum_into, adam_, no_tf32
from benchmark.reference.keepmask import kept


@dataclass
class Drop:
    """One step's dropout. Per train edge (``Graph.u[e]``, ``Graph.i[e]``):
    whether the user's row keeps it (``edge_u``) and whether the item's
    row does (``edge_i``); the self-loops' keeps, (n_users,) and
    (n_items,) bool; and each layer's (n, size) bool feature keep."""

    edge_u: torch.Tensor
    edge_i: torch.Tensor
    self_u: torch.Tensor
    self_i: torch.Tensor
    feat: list

    @staticmethod
    def of_seeds(g: Graph, seed_b: int, seed_bt: int, p: float, self_u,
                 self_i, feat) -> "Drop":
        """The drop of the two directions' mask seeds: users' rows keep
        the edges ``seed_b`` keeps, items' rows those of ``seed_bt``."""
        return Drop(kept(seed_b, g.u, g.i, p), kept(seed_bt, g.u, g.i, p),
                    self_u, self_i, list(feat))


def message(g: Graph, x: torch.Tensor, p: float, drop=None) -> torch.Tensor:
    """m0 = (A + I) x / (deg + 1) under the step's edge drop."""
    nu, ni = g.n_users, g.n_items
    du, di = g.degrees(x.dtype)
    xu, xi = x[:nu], x[nu:]
    if drop is None:
        yu = _sum_into(nu, g.u, xi[g.i]) + xu
        yi = _sum_into(ni, g.i, xu[g.u]) + xi
    else:
        ku, ki = drop.edge_u, drop.edge_i
        scale = 1.0 / (1.0 - p)
        yu = (_sum_into(nu, g.u[ku], xi[g.i[ku]])
              + drop.self_u[:, None].to(x.dtype) * xu) * scale
        yi = (_sum_into(ni, g.i[ki], xu[g.u[ki]])
              + drop.self_i[:, None].to(x.dtype) * xi) * scale
    return torch.cat([yu / (du + 1.0)[:, None], yi / (di + 1.0)[:, None]])


def rep(params: dict, g: Graph, cfg: dict, drop=None) -> torch.Tensor:
    """(n_users + n_items, d + sum(layer_sizes)) representations;
    ``params`` by the program's dotted names (``embedding``,
    ``gc_layers.<l>.w`` ...)."""
    p = cfg["dropout"]
    x = params["embedding"]
    outs = [x]
    for layer in range(len(cfg["layer_sizes"])):
        m0 = message(g, x, p, drop)
        gc, bi = f"gc_layers.{layer}.", f"bi_layers.{layer}."
        h = F.leaky_relu(m0 @ params[gc + "w"] + params[gc + "b"]
                         + (x * m0) @ params[bi + "w"] + params[bi + "b"],
                         negative_slope=0.2)
        if drop is not None:
            h = torch.where(drop.feat[layer], h / (1.0 - p), 0.0)
        x = h
        outs.append(F.normalize(h, dim=1))
    return torch.cat(outs, dim=1)


def loss(params: dict, g: Graph, cfg: dict, batch, drop=None):
    r = rep(params, g, cfg, drop)
    users, pos, neg = batch
    u, pp, n = r[users], r[g.n_users + pos], r[g.n_users + neg]
    l2 = (u * u).sum(1) + (pp * pp).sum(1) + (n * n).sum(1)
    bpr = F.softplus((u * n).sum(1) - (u * pp).sum(1)).mean()
    return bpr + cfg["l2_reg"] * l2.mean()


def follow(init: dict, g: Graph, cfg: dict, steps: list,
           dtype=torch.float64) -> Steps:
    """Train from ``init`` through ``steps`` (each a (batch, drop) pair,
    drop a ``Drop`` or None) with Adam at ``cfg``'s learning rate,
    computing in ``dtype``: each step's loss, the first step's gradient and
    each leaf's change, as ``compare.train_numbers`` reads them."""
    params = {k: v.detach().to(dtype).clone().requires_grad_()
              for k, v in init.items()}
    names = list(params)
    state: dict = {}
    losses, grad1 = [], None
    with no_tf32():
        for batch, drop in steps:
            value = loss(params, g, cfg, batch, drop)
            grads = dict(zip(names, torch.autograd.grad(
                value, [params[n] for n in names])))
            losses.append(float(value.detach().double()))
            if grad1 is None:
                grad1 = {n: gr.detach().double() for n, gr in grads.items()}
            adam_(params, grads, state, cfg["lr"])
    change = {n: p.detach().double() - init[n].detach().double()
              for n, p in params.items()}
    return Steps(losses, grad1, change)
