"""The kernel ops under sharding: each public op (flash attention, the
grouped matmul, the SSD scan, the WKV recurrence) that is given DTensors
runs its kernel (or, for a CPU tensor, its plain version) on each rank's
local shards through ``local_map``.  DTensor is never taught the ops.

Each op reads the placements its inputs arrive with, per mesh dim, and
chooses the local layout from them:

* flash, ssd and wkv split by heads (and by batch); the operands without a
  head dim (ssd's B and C, wkv's bonus u on a batch-split dim) are
  replicated there, and their gradients are partial sums;
* gmm splits by experts (EP), by the weights' output dim (TP inside the
  experts: the input replicated, its gradient a partial sum) or by the
  contraction dim (the output a partial sum), as the weight is placed;
* flash's k and v are split by heads too where the kv heads divide the
  mesh dims that split q's heads.  Otherwise they stay whole and each rank
  takes exactly the kv heads its local q heads read: heads
  ``[r * Hq_l, (r + 1) * Hq_l) // G`` for local q count ``Hq_l`` and group
  size ``G``, as a slice when they group evenly and by index otherwise.

Any other placement is first redistributed to replicated.  The local
operands the kernels read through TMA are made contiguous.

The same module holds the model's other lookups that DTensor cannot run
as it stands: the vocab-split embedding and the targets' logits of the
loss (each rank its own vocab range, a partial sum), and, for serving
without grad, the write into sequence-split KV ring buffers and decode
attention over them (a distributed flash-decode).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def is_sharded(*ts) -> bool:
    return any(isinstance(t, DTensor) for t in ts)


def _as_dtensor(t, mesh):
    """A plain tensor (the same on every rank) as a replicated DTensor."""
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _offset(mesh, dims: Sequence[int]) -> int:
    """The linear index of this rank's shard along the mesh dims ``dims``
    (major to minor)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _n(mesh, dims: Sequence[int]) -> int:
    out = 1
    for i in dims:
        out *= mesh.size(i)
    return out


def _run(fn, args, in_pl, out_pl, grad_pl, mesh):
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def local_kv_heads(k: torch.Tensor, start: int, n_q: int, group: int
                   ) -> torch.Tensor:
    """The kv heads (dim 2 of ``k``) that q heads ``[start, start + n_q)``
    read under GQA with group size ``group``, in the layout the kernel's
    native GQA pairs them (q head h with kv head h // (n_q / kv count))."""
    lo, hi = start // group, (start + n_q - 1) // group + 1
    if n_q % group == 0 and start % group == 0:
        return k[:, :, lo:hi].contiguous()
    if group % n_q == 0:                 # all local q heads read one kv head
        return k[:, :, lo:hi].contiguous()
    idx = torch.arange(start, start + n_q, device=k.device) // group
    return k.index_select(2, idx).contiguous()


def flash(op, q, k, v, q_pos, k_pos, *, window, causal, impl, return_lse):
    """``op`` (the public flash op) on local shards: q split by batch and
    heads as it arrives, k and v split the same way where their heads
    allow, else whole with the right heads taken locally."""
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    Hq, Hkv = q.shape[2], k.shape[2]
    head_dims = [i for i, pl in enumerate(q.placements) if pl == Shard(2)
                 and Hq % mesh.size(i) == 0]
    kv_split = Hkv % _n(mesh, head_dims) == 0
    qp: List = []
    kp: List = []
    kg: List = []
    for i, pl in enumerate(q.placements):
        if i in head_dims:
            qp.append(Shard(2))
            kp.append(Shard(2) if kv_split else Replicate())
            kg.append(Shard(2) if kv_split else Partial())
        elif pl == Shard(0):
            qp.append(Shard(0))
            kp.append(Shard(0))
            kg.append(Shard(0))
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kg.append(Replicate())
    n_q = Hq // _n(mesh, head_dims)
    start = _offset(mesh, head_dims) * n_q
    group = Hq // Hkv

    def fn(ql, kl, vl):
        if not kv_split:
            kl = local_kv_heads(kl, start, n_q, group)
            vl = local_kv_heads(vl, start, n_q, group)
        return op(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                  q_pos, k_pos, window=window, causal=causal, impl=impl,
                  return_lse=return_lse)

    out_pl = qp
    if return_lse:    # lse (B, Hq, S)
        lse_pl = [Shard(1) if pl == Shard(2) else pl for pl in qp]
        out_pl = (qp, lse_pl)
    return _run(fn, (q, k, v), (qp, kp, kp), out_pl, (qp, kg, kg), mesh)


def gmm(op, x, w, *, impl):
    """``op`` (the public grouped matmul) on local shards, laid out by the
    weight's placement on each mesh dim (module docstring)."""
    mesh = (w if isinstance(w, DTensor) else x).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    nd = x.ndim
    e_dim, k_dim = nd - 3, nd - 1
    xp: List = []
    wp: List = []
    op_: List = []
    xg: List = []
    wg: List = []
    for i in range(mesh.ndim):
        pw, px = w.placements[i], x.placements[i]
        if pw == Shard(0):
            xp.append(Shard(e_dim)); wp.append(Shard(0))
            op_.append(Shard(e_dim)); xg.append(Shard(e_dim))
            wg.append(Shard(0))
        elif pw == Shard(1):
            xp.append(Shard(k_dim)); wp.append(Shard(1))
            op_.append(Partial()); xg.append(Shard(k_dim))
            wg.append(Shard(1))
        elif pw == Shard(2):
            xp.append(Replicate()); wp.append(Shard(2))
            op_.append(Shard(nd - 1)); xg.append(Partial())
            wg.append(Shard(2))
        elif nd == 4 and px == Shard(0):
            xp.append(Shard(0)); wp.append(Replicate())
            op_.append(Shard(0)); xg.append(Shard(0))
            wg.append(Partial())
        else:
            xp.append(Replicate()); wp.append(Replicate())
            op_.append(Replicate()); xg.append(Replicate())
            wg.append(Replicate())

    def fn(xl, wl):
        return op(xl.contiguous(), wl.contiguous(), impl=impl)

    return _run(fn, (x, w), (xp, wp), op_, (xg, wg), mesh)


def ssd(op, xdt, a, Bm, Cm, init_state, *, impl):
    """``op`` (the public SSD scan) on local shards: split by batch and by
    heads as ``xdt`` (B,S,H,P) arrives; B and C (B,S,N) stay whole on a
    head-split dim."""
    mesh = xdt.device_mesh if isinstance(xdt, DTensor) else a.device_mesh
    xdt, a, Bm, Cm, init_state = (_as_dtensor(t, mesh)
                                  for t in (xdt, a, Bm, Cm, init_state))
    H = xdt.shape[2]
    pls = {k: [] for k in ("x", "a", "bc", "st", "bcg")}
    for i, pl in enumerate(xdt.placements):
        if pl == Shard(2) and H % mesh.size(i) == 0:
            row = (Shard(2), Shard(2), Replicate(), Shard(1), Partial())
        elif pl == Shard(0):
            row = (Shard(0), Shard(0), Shard(0), Shard(0), Shard(0))
        else:
            row = (Replicate(),) * 5
        for key, p in zip(pls, row):
            pls[key].append(p)
    args = [xdt, a, Bm, Cm]
    in_pl = [pls["x"], pls["a"], pls["bc"], pls["bc"]]
    grad_pl = [pls["x"], pls["a"], pls["bcg"], pls["bcg"]]
    if init_state is not None:
        args.append(init_state)
        in_pl.append(pls["st"])
        grad_pl.append(pls["st"])

    def fn(xl, al, bl, cl, sl=None):
        return op(xl.contiguous(), al.contiguous(), bl.contiguous(),
                  cl.contiguous(), sl, impl=impl)

    return _run(fn, args, in_pl, (pls["x"], pls["st"]), grad_pl, mesh)


def wkv(op, r, k, v, w, u, init_state, *, impl):
    """``op`` (the public WKV recurrence) on local shards: split by batch
    and by heads as ``r`` (B,S,H,P) arrives; k, v and w follow r, u (H,P)
    is split by heads and whole on a batch-split dim."""
    mesh = next(t.device_mesh for t in (r, k, v, w, u)
                if isinstance(t, DTensor))
    r, k, v, w, u, init_state = (_as_dtensor(t, mesh)
                                 for t in (r, k, v, w, u, init_state))
    H = r.shape[2]
    pls = {key: [] for key in ("x", "u", "st", "ug")}
    for i, pl in enumerate(r.placements):
        if pl == Shard(2) and H % mesh.size(i) == 0:
            row = (Shard(2), Shard(0), Shard(1), Shard(0))
        elif pl == Shard(0):
            row = (Shard(0), Replicate(), Shard(0), Partial())
        else:
            row = (Replicate(),) * 4
        for key, p in zip(pls, row):
            pls[key].append(p)
    args = [r, k, v, w, u]
    in_pl = [pls["x"]] * 4 + [pls["u"]]
    grad_pl = [pls["x"]] * 4 + [pls["ug"]]
    if init_state is not None:
        args.append(init_state)
        in_pl.append(pls["st"])
        grad_pl.append(pls["st"])

    def fn(rl, kl, vl, wl, ul, sl=None):
        return op(rl.contiguous(), kl.contiguous(), vl.contiguous(),
                  wl.contiguous(), ul.contiguous(), sl, impl=impl)

    return _run(fn, args, in_pl, (pls["x"], pls["st"]), grad_pl, mesh)


def vocab_gather(logits, targets):
    """``logits[..., targets]`` for a DTensor ``logits`` (..., V): where
    the vocab is split, each rank gathers the targets in its own range and
    zero elsewhere, a partial sum (the embedding's trick); other dims
    split as ``logits`` arrives, ``targets`` with them."""
    mesh = logits.device_mesh
    targets = _as_dtensor(targets, mesh)
    v_dim = logits.ndim - 1
    lp: List = []
    tp: List = []
    op_: List = []
    v_dims = []
    for i, pl in enumerate(logits.placements):
        if pl == Shard(v_dim) and logits.shape[-1] % mesh.size(i) == 0:
            lp.append(pl); tp.append(Replicate()); op_.append(Partial())
            v_dims.append(i)
        elif isinstance(pl, Shard) and pl.dim < v_dim:
            lp.append(pl); tp.append(pl); op_.append(pl)
        else:
            lp.append(Replicate()); tp.append(Replicate())
            op_.append(Replicate())
    n_v = logits.shape[-1] // _n(mesh, v_dims)
    start = _offset(mesh, v_dims) * n_v

    def fn(ll, tl):
        t = tl.long() - start
        inside = (t >= 0) & (t < n_v)
        g = torch.gather(ll, -1, t.clamp(0, n_v - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros_like(g))

    return _run(fn, (logits, targets), (lp, tp), op_, (lp, tp), mesh)


# ---------------------------------------------------------------------------
# Serving caches (no grad): the ring buffers split by batch and along the
# sequence, as the rules' cache specs place them
# ---------------------------------------------------------------------------


def _rows(placements) -> List:
    """Split by batch where ``placements`` split dim 0, else whole."""
    return [Shard(0) if pl == Shard(0) else Replicate() for pl in placements]


def _seq_dims(cache) -> List[int]:
    return [i for i, pl in enumerate(cache.placements) if pl == Shard(1)]


@torch.no_grad()
def cache_write(cache, k, v, cache_pos: int) -> None:
    """Write the last min(S, Tc) tokens of k/v (B,S,kv,D) into the ring
    buffers ``cache["k"]``, ``cache["v"]`` (DTensors (B,Tc,kv,D)), each
    rank the slots of its own sequence range, in place."""
    ck = cache["k"]
    mesh = ck.device_mesh
    rows = _rows(ck.placements)
    k = _as_dtensor(k, mesh).redistribute(mesh, rows).to_local()
    v = _as_dtensor(v, mesh).redistribute(mesh, rows).to_local()
    Tc, S = ck.shape[1], k.shape[1]
    seq = _seq_dims(ck)
    t_l = Tc // _n(mesh, seq)
    lo = _offset(mesh, seq) * t_l
    Lw = min(S, Tc)
    # the slots depend on the positions alone: computed on the host, so a
    # meta cache (the dry run) takes the same path
    slots = (cache_pos + S - Lw + torch.arange(Lw)) % Tc
    mine = ((slots >= lo) & (slots < lo + t_l)).nonzero()[:, 0]
    dst, src = (slots[mine] - lo).to(k.device), mine.to(k.device)
    for buf, new in ((ck, k), (cache["v"], v)):
        local = buf.to_local()
        local.index_copy_(1, dst, new[:, S - Lw:].index_select(1, src)
                          .to(local.dtype))


def _all_reduce(t, mesh, dims, op):
    import torch.distributed as dist
    for i in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


@torch.no_grad()
def decode_attention(q, k_cache, v_cache, q_pos, k_pos, window: int,
                     causal: bool, n_kv: int):
    """Decode attention over sequence-split caches (a distributed
    flash-decode): q (B,S,H,D); k_cache, v_cache DTensors (B,T,kv,D).
    Each rank scores its own slots (``k_pos`` (T,) the slots' positions,
    masked as the single-device path masks them, when ``causal``); the
    softmax's max and sum and the output's sum are all-reduced over the
    mesh dims that split the sequence.  Returns (B,S,H,D), split by batch
    as the caches are."""
    import torch.distributed as dist

    from ..models.layers import NEG_INF

    mesh = k_cache.device_mesh
    rows = _rows(k_cache.placements)
    q = _as_dtensor(q, mesh).redistribute(mesh, rows).to_local()
    k, v = k_cache.to_local(), v_cache.to_local()
    seq = _seq_dims(k_cache)
    t_l = k_cache.shape[1] // _n(mesh, seq)
    lo = _offset(mesh, seq) * t_l
    B, S, H, D = q.shape
    qg = q.reshape(B, S, n_kv, H // n_kv, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k).float() \
        * (1.0 / math.sqrt(D))
    if causal:
        kp = k_pos[lo:lo + t_l]
        mask = kp[None, :] <= q_pos[:, None]
        if window:
            mask &= (q_pos[:, None] - kp[None, :]) < window
        mask &= (kp >= 0)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    m = _all_reduce(scores.amax(dim=-1, keepdim=True), mesh, seq,
                    dist.ReduceOp.MAX)
    e = torch.exp(scores - m)
    total = _all_reduce(e.sum(dim=-1, keepdim=True), mesh, seq,
                        dist.ReduceOp.SUM)
    probs = (e / total).to(q.dtype)
    out = _all_reduce(torch.einsum("bhgst,bthd->bshgd", probs.float(),
                                   v.float()), mesh, seq, dist.ReduceOp.SUM)
    return DTensor.from_local(out.to(q.dtype).reshape(B, S, H, D), mesh,
                              rows, run_check=False)


def embedding(table, tokens):
    """``table[tokens]`` for a DTensor ``table`` (V, D): where the vocab is
    split, each rank looks up the tokens in its own range and zero
    elsewhere, a partial sum (the vocab-parallel embedding); where the
    table is whole, the tokens keep their batch split."""
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    tp_: List = []
    kp: List = []
    op_: List = []
    tg: List = []
    v_dims = []
    for i, pl in enumerate(table.placements):
        if pl == Shard(0) and table.shape[0] % mesh.size(i) == 0:
            tp_.append(Shard(0)); kp.append(Replicate())
            op_.append(Partial()); tg.append(Shard(0))
            v_dims.append(i)
        elif tokens.placements[i] == Shard(0):
            tp_.append(Replicate()); kp.append(Shard(0))
            op_.append(Shard(0)); tg.append(Partial())
        else:
            tp_.append(Replicate()); kp.append(Replicate())
            op_.append(Replicate()); tg.append(Replicate())
    n_v = table.shape[0] // _n(mesh, v_dims)
    start = _offset(mesh, v_dims) * n_v

    def fn(tl, kl):
        t = kl.long() - start
        inside = (t >= 0) & (t < n_v)
        rows = tl[t.clamp(0, n_v - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return _run(fn, (table, tokens), (tp_, kp), op_, (tg, kp), mesh)
