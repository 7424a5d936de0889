"""The meshed kernel chain: K1, K2, K2, K3 over the shards of a device mesh
(``_get_jit(..., mesh=...)``, ``_pin`` and ``mesh_constraints`` in
``karpenter_tpu/solver/jax_solver.py``, with ``parallel/mesh.py``'s
placements).

A mesh's shards may be distinct cards or logical shards of one card (the
same device named several times); each shard runs its kernels on its own
stream, and shards exchange ordered by events, never through the host.
Where the shards share memory (one card, or cards that all have peer
access to each other: ``_shared_regions``), a shard's kernel reads the
other shards' buffers in place through a table of device pointers in its
parameters, once its stream has waited on each sender's event; else the
buffers it reads are copied to it first (``_read_from``) and the same
kernel reads the copies through the same table. Every cross-shard step is
a min, an ``any``, or an argmax/argmin with a fixed tie rule, so a meshed
chain answers bit for bit what the un-meshed chain answers
(``torch_solver.pack_solve_fused``).

**1D portfolio mesh** (``P(portfolio)`` member arrays). Each shard holds
the whole problem and K/n members: K1 on every shard, phase 1 of K2 on its
members, then the cross-shard member argmin (``member_argmin``): each
shard's ``mesh_seed`` picks the seed over every shard's phase-1 costs by
``jnp.argmin``'s rule (the first NaN, else the lowest cost, lowest index on
ties) and builds its phase-2 members from the winner's order row, alpha,
look and rsv, read where the winner lies. K2's phase 2 and K3 run on each
shard's members; the root's ``final_pick`` reads the shards' K3 buffers and
picks the winner over the 2K costs by the same rule: n + 1 launches a chain
and, on one card, no copy. A fleet dispatch's batch rows split over the
shards instead (``fleet_shardings``), each shard running the un-meshed
chain on its rows.

**2D options x fleet mesh** (rule-table placements). Batch rows split over
``fleet``; within a fleet column, each shard holds the option columns
``[c0, c0 + O/n)`` of ``compat``, ``alloc``, ``price``, ``opt_zone`` and
``opt_valid`` and every group-, slot- and zone-shaped leaf whole.

* K1 (``shard_precompute_part`` then ``shard_precompute_finish``): each
  shard computes its columns' unit counts and a partial ``lam`` (the
  cheapest rate, a min) and ``row_fits`` (an ``any``); each shard's finish,
  one launch, reduces every shard's partials (read in place on one card)
  and computes the value table over its columns with the global ``lam``.
* K2 (``shard_member``): each member's slot state is replicated on every
  shard, as XLA replicates it. A step is four launches, each followed by an
  exchange: (A) the last step's tail choices, segments and opened slots,
  then fill open capacity and the per-bucket wants, then the shard's lump
  and rate score minima; (B) the global minima, then each shard's in-band
  argmax (value, global index, and the option's units, effective price,
  price, zone, alloc row and compat column); (C) the global lump and rate
  choices, the tail wants from the rate choice's units, and the shard's
  tail minima; (D) the global tail minima and the shard's tail argmax. The
  end opens the last step's slots. A slot opened on an option keeps its
  compat column (``compat[:, o]``, a bit a group), so that every shard
  knows which open slots admit the next group without an exchange. The
  combine of an argmax takes the larger value, the lower global index on
  ties: ``_argmin_tiebreak``'s rule; the tie rules need the minima before
  the argmaxes and the rate choice before the tail, so no two of the four
  exchanges merge.
* K3 is the un-meshed ``pack_epilogue`` on the column's first shard.

**The phase entry** (``_issue_phase``, ``kts_k2m_phase`` in
``csrc/pack_solve.cu``): on the card one call issues a whole K2 phase:
each shard's begin, the G steps of four stages with an exchange after
each, each shard's end, then every shard's stream waits on every other's
end. An exchange records each shard's event and makes every other shard's
stream wait on it. The shards of one card (or of cards with peer access)
share one copy of each region and read the others' rows in place; else
each holds its own copy and the exchange copies the sender's row into it.
In place needs no copy to be safe: shard s rewrites region r at stage r
of step t + 1 only after waiting on every shard's stage before it (the
tail_pick of step t, for the fill's region), and on each shard's stream
that stage follows the one that read region r at step t (the next stage;
the fill of step t + 1, for the tail_pick's region). The call issues
this loop from C; ``PHASE_MODE = "stages"`` issues the same launches and
exchanges from Python, for comparisons only. A phase's buffers are new
each call.

Design rule of the 2D chain, what ``_pin`` and ``mesh_constraints``
guarantee in the JAX package: ``units``, ``units_rsv``, ``val_pair``, the
lookahead prices and the per-step option scores stay split by option
columns on their shards and are never gathered whole; what crosses shards
per step is O(buckets) records a member, each of 6 + R + ceil(G / 32)
words.

Differences from the reference, deliberate: an option a shard opens a slot
with travels in the exchange record (its units, prices, zone, alloc row and
compat column), and each opened slot keeps its option's price and compat
column, so that no shard needs a replica of another's option tables; an
unbatched problem on a 2D mesh runs on the first fleet column's shards
(the others hold replicas and idle), and
a batch that does not divide the fleet axis runs whole on that column, as a
replicated placement would compute it. A meshed launch, build or exchange
error raises.

Beside each kernel wrapper sits its plain PyTorch version, which the wrapper
takes for CPU tensors; ``LAUNCHES`` counts the new wrappers' kernel launches
(``csrc/pack_solve.cu``'s meshed-tier kernels).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import List, NamedTuple, Sequence

import torch

from . import torch_solver as ts
from .torch_solver import (
    _BOOL, _F32, _I32, INF, MemberOut, PackInputs, Shared, TIE_BAND, UNPLACED_PENALTY,
    _ceil_div, _cumsum, _fma, _isum, _row, _stack, _units,
)

_INF = float(INF)
_IBIG = int(ts.IBIG)
_INT_MAX = 0x7FFFFFFF

#: stages of a meshed K2 step, in launch order
STAGES = ("fill", "pick", "tail", "tail_pick")

#: kernel launches per wrapper of the meshed tier (the un-meshed kernels the
#: chains also launch count in ``torch_solver.LAUNCHES``)
LAUNCHES = {"shard_precompute_part": 0, "shard_precompute_finish": 0, "shard_member": 0,
            "member_argmin": 0}
#: buffers copied to a shard for a wrapper's kernel to read (``_read_from``):
#: none where the shards share memory
COPIES = {"shard_precompute_finish": 0, "member_argmin": 0}


def _count(name: str) -> None:
    with ts._COUNT_LOCK:
        LAUNCHES[name] += 1


def _rec_words(R: int, G: int) -> int:
    """Words of an exchanged option record: value, global index, units,
    effective price, price, zone, then the alloc row and the compat column
    (bit g of word g // 32: whether group g may use the option)."""
    return 6 + R + _bit_words(G)


def _bit_words(S: int) -> int:
    return (S + 31) // 32


# ---------------------------------------------------------------------------
# Shards, streams and exchanges
# ---------------------------------------------------------------------------

class _Shard:
    """One mesh entry taking part in a chain: its device, stream and event."""

    __slots__ = ("index", "device", "stream", "event")

    def __init__(self, mesh, index: int):
        self.index = index
        self.device = mesh.flat()[index]
        self.stream = mesh.stream(index) if self.device.type == "cuda" else None
        self.event = torch.cuda.Event() if self.device.type == "cuda" else None


@contextlib.contextmanager
def _on(shard: _Shard):
    """Make the shard's device and stream current."""
    if shard.stream is None:
        yield
        return
    with torch.cuda.device(shard.device), torch.cuda.stream(shard.stream):
        yield


def _all_gather(shards: Sequence[_Shard], regions: Sequence[torch.Tensor]) -> None:
    """Exchange: shard s has written ``regions[s][s]``; copy it to
    ``regions[j][s]`` on every other shard j (nothing to copy where the two
    shards share the region). Each copy runs on the receiver's stream after
    an event on the sender's, so that it follows the sender's write and
    precedes the receiver's next launch."""
    n = len(shards)
    if n == 1:
        return
    cuda = shards[0].stream is not None
    if cuda:
        for s in shards:
            s.event.record(s.stream)
    for j, sj in enumerate(shards):
        if not cuda:
            for s in range(n):
                if s != j and regions[j] is not regions[s]:
                    regions[j][s].copy_(regions[s][s])
            continue
        with _on(sj):
            for s, ss in enumerate(shards):
                if s != j:
                    sj.stream.wait_event(ss.event)
                    if regions[j] is not regions[s]:
                        regions[j][s].copy_(regions[s][s], non_blocking=True)


def _record(shards: Sequence[_Shard]) -> None:
    """Each shard's event after the work enqueued on its stream so far."""
    if shards[0].stream is not None:
        for s in shards:
            s.event.record(s.stream)


def _read_from(rx: _Shard, shards: Sequence[_Shard], bufs: Sequence[tuple], shared: bool,
               what: str) -> List[tuple]:
    """What receiver ``rx``'s next launch reads of every shard's buffers
    (``bufs[s]``, a tuple of shard s's tensors), after ``_record``: rx's
    stream waits on every other shard's event, then each other shard's
    tensors are read in place where the shards share memory, else copied to
    rx on its stream (counted in ``COPIES[what]``). Either way rx's stream
    reads them, so each is recorded on that stream: the allocator hands its
    memory out again only after that read, however soon its owner frees it."""
    out = []
    for sh, ts_ in zip(shards, bufs):
        if sh is rx:
            out.append(ts_)
            continue
        if rx.stream is not None:
            rx.stream.wait_event(sh.event)
            for t in ts_:
                t.record_stream(rx.stream)
        if shared:
            out.append(ts_)
            continue
        with _on(rx):
            out.append(tuple(t.to(rx.device, copy=True, non_blocking=True) for t in ts_))
        with ts._COUNT_LOCK:
            COPIES[what] += len(ts_)
    return out


def _gather_to(root: _Shard, shards: Sequence[_Shard], srcs: Sequence[torch.Tensor],
               dst: torch.Tensor) -> None:
    """``dst[i] = srcs[i]`` on the root's stream, each copy after an event
    on its sender's stream (the source recorded on the root's stream, which
    reads it)."""
    cuda = root.stream is not None
    for i, (s, src) in enumerate(zip(shards, srcs)):
        if cuda:
            if s is not root:
                s.event.record(s.stream)
                root.stream.wait_event(s.event)
                src.record_stream(root.stream)
            with _on(root):
                dst[i].copy_(src, non_blocking=True)
        else:
            dst[i].copy_(src)


# ---------------------------------------------------------------------------
# K1 on an option shard: plain versions
# ---------------------------------------------------------------------------

class ShardPart(NamedTuple):
    """What ``shard_precompute_part`` leaves on its shard for the finish."""

    units: torch.Tensor  # [B, G, O] finished unit counts of the shard's columns
    units_rsv: torch.Tensor  # [B, G, O] raw reserve-sized counts (finished later)
    rsv_group: torch.Tensor  # [B, G]
    zone_limited: torch.Tensor  # [B, G]
    exok_pad: torch.Tensor  # [B, G, E+S]
    is_new: torch.Tensor  # [B, E+S]


def shard_precompute_part_ref(inputs: PackInputs, s_new: int, part: torch.Tensor) -> ShardPart:
    """One shard's K1 part over its option columns, rows of a ``[B, ...]``
    batch: the finished unit counts, the raw reserve-sized counts, and into
    ``part`` (``[2, B, G, tiles]`` int32 words) each group's partial minimum
    rate (f32 bits, a min) and whether any of its columns fits the reserve
    (an any), in column 0 of the tiles."""
    B = inputs.demand.shape[0]
    outs = []
    pmin = part[0].view(_F32)
    for b in range(B):
        x = _row(inputs, b)
        G = x.demand.shape[0]
        E = x.ex_rem.shape[0]
        ok = x.compat & x.opt_valid[None, :]
        units_raw = ts.sized_units_ref(x, x.demand)
        units_rsv = ts.sized_units_ref(x, x.demand_units)
        fits = ((units_rsv > 0) & ok).any(1)
        units = ts.finish_units_ref(x, units_raw)
        rate = torch.where(units > 0, x.price[None, :] / torch.clamp(units.float(), min=1.0), _INF)
        pmin[b, :, :] = _INF
        pmin[b, :, 0] = rate.amin(1)
        part[1, b, :, :] = 0
        part[1, b, :, 0] = fits.to(_I32)
        ex_ok = x.ex_compat & x.ex_valid[None, :]
        outs.append(ShardPart(
            units=units, units_rsv=units_rsv,
            rsv_group=(x.demand_units != x.demand).any(1),
            zone_limited=(x.quota < _IBIG).any(1),
            exok_pad=torch.cat([ex_ok, torch.zeros((G, s_new), dtype=_BOOL, device=ex_ok.device)], 1),
            is_new=torch.arange(E + s_new, device=ex_ok.device) >= E,
        ))
    return _stack(outs)


def shard_precompute_finish_ref(inputs: PackInputs, sp: ShardPart, parts: Sequence[torch.Tensor]) -> Shared:
    """Combine every shard's partials (``parts[s]``, ``[2, B, G, tiles]``:
    the min of the rates, the any of the fits), finish the reserve-sized
    counts and compute the value table over this shard's columns with the
    global ``lam``."""
    B = inputs.demand.shape[0]
    dev = inputs.demand.device
    stacked = torch.stack([p.to(dev) for p in parts])
    lam_raw = stacked[:, 0].view(_F32).amin(-1).amin(0)  # [B, G]
    row_fits = (stacked[:, 1] != 0).any(-1).any(0)  # [B, G]
    outs = []
    for b in range(B):
        x = _row(inputs, b)
        units_raw = ts.sized_units_ref(x, x.demand)
        ur = torch.where(~row_fits[b][:, None] & (units_raw > 0), units_raw, sp.units_rsv[b])
        lam = torch.where(lam_raw[b] < _INF, lam_raw[b], 0.0)
        outs.append(Shared(
            units=sp.units[b], units_rsv=ts.finish_units_ref(x, ur), rsv_group=sp.rsv_group[b],
            lam=lam, quota=x.quota, zone_limited=sp.zone_limited[b],
            val_pair=ts.val_pair_ref(x, sp.units[b], lam), exok_pad=sp.exok_pad[b],
            is_new=sp.is_new[b],
        ))
    return _stack(outs)


# ---------------------------------------------------------------------------
# K2 on an option shard: plain versions
# ---------------------------------------------------------------------------

class MemberShard:
    """One shard's part of one meshed K2 phase: its inputs and precompute
    (its option columns from ``c0``), the member arrays, the exchange
    regions (``regions[stage]``: ``[n, B, K, ...]`` int32, row ``self_`` its
    own, the others its copies of the other shards' rows) and the replicated
    member state (a dict of tensors for the plain version, a byte buffer for
    the kernels). ``bufs`` (``_member_buffers``) holds the regions, ``ys``
    and the kernels' state; without it (the plain versions) the regions and
    ``ys`` are new and the begin makes the state."""

    def __init__(self, inputs, shared, orders, alphas, looks, rsvs, swaps, seed_costs,
                 s_new: int, c0: int, n: int, self_: int, bufs=None):
        self.inputs, self.shared = inputs, shared
        self.orders, self.alphas, self.looks, self.rsvs = orders, alphas, looks, rsvs
        self.swaps, self.seed_costs = swaps, seed_costs
        self.s_new, self.c0, self.n, self.self_ = s_new, c0, n, self_
        self.dims = _member_dims(inputs, orders)
        if bufs is None:
            bufs = _member_buffers(self.dims, s_new, n, inputs.demand.device)
        self.regions, self.ys, self.state = bufs["regions"], bufs["ys"], bufs.get("state")


def _member_dims(inputs, orders) -> tuple:
    """B K G O E R Z of a shard's phase (O: its columns)."""
    B, K, G = orders.shape
    return (B, K, G, inputs.price.shape[-1], inputs.ex_rem.shape[-2], inputs.demand.shape[-1],
            inputs.rel_zone_bits.shape[-1])


def _member_buffers(dims, s_new: int, n: int, dev, state_bytes: int = 0, regions=None) -> dict:
    """A shard's exchange regions (new, or ``regions``: the ones it shares)
    and phase outputs (``ys``), and with ``state_bytes`` the kernels' member
    state and results."""
    B, K, G, O, E, R, Z = dims
    Zb, RW, S = Z + 1, _rec_words(R, G), s_new
    # one zeroed allocation for the new regions and ys
    shapes = [] if regions else [(n, B, K, Zb, 2), (n, B, K, 2, Zb, RW), (n, B, K, Zb), (n, B, K, Zb, RW)]
    shapes.append((B, K, G, E + S))
    sizes = [torch.Size(sh).numel() for sh in shapes]
    *made, ys = (x.view(sh) for x, sh in zip(torch.zeros(sum(sizes), dtype=_I32, device=dev).split(sizes),
                                              shapes))
    bufs = dict(regions=regions or tuple(made), ys=ys)
    if state_bytes:
        bufs["state"] = dict(
            price_t=torch.empty((B, K, G, O), dtype=_F32, device=dev),
            bytes=torch.empty((B, K, state_bytes), dtype=torch.uint8, device=dev),
            cost=torch.empty((B, K), dtype=_F32, device=dev),
            unplaced=torch.empty((B, K), dtype=_I32, device=dev),
            exhausted=torch.empty((B, K), dtype=_BOOL, device=dev),
            new_opt=torch.empty((B, K, S), dtype=_I32, device=dev),
            new_active=torch.empty((B, K, S), dtype=_BOOL, device=dev),
        )
    return bufs


def _unpack_bits(words: torch.Tensor, S: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., S] bool, bit j of word j // 32."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))[..., :S].bool()


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    S = bits.shape[-1]
    W = _bit_words(S)
    padded = torch.zeros(bits.shape[:-1] + (W * 32,), dtype=torch.int64, device=bits.device)
    padded[..., :S] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(bits.shape[:-1] + (W, 32)) << shifts).sum(-1)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(_I32)


def _f(x: torch.Tensor) -> torch.Tensor:
    return x.view(_F32)


def _i(x: torch.Tensor) -> torch.Tensor:
    return x.view(_I32)


def _combine_records(recs: torch.Tensor) -> torch.Tensor:
    """The winning record over shards (axis 0): the largest value, the lowest
    global index on ties."""
    v = _f(recs[..., 0].contiguous())
    idx = recs[..., 1]
    best = v.amax(0, keepdim=True)
    key = torch.where(v == best, idx, _INT_MAX)
    win = key.argmin(0)
    return torch.gather(recs, 0, win[None, ..., None].expand((1,) + recs.shape[1:]))[0]


def _k2m_begin_ref(ms: MemberShard) -> None:
    B, K, G, O, E, R, Z = ms.dims
    x, sh = ms.inputs, ms.shared
    S = ms.s_new
    NS = E + S
    dev = x.demand.device
    orders, alphas, looks, rsvs, price_t = [], [], [], [], []
    for b in range(B):
        o_b, a_b, l_b, r_b = ms.orders[b], ms.alphas[b], ms.looks[b], ms.rsvs[b]
        if ms.seed_costs is not None:
            o_b, a_b, l_b, r_b = ts.phase2_members(o_b, a_b, l_b, r_b, ms.swaps[b], ms.seed_costs[b])
        orders.append(o_b)
        alphas.append(a_b)
        looks.append(l_b)
        rsvs.append(r_b)
        price_t.append(ts._lookahead_prices(_row(x, b), _row(sh, b), o_b, l_b))
    bi = torch.arange(B, device=dev).repeat_interleave(K)
    M = B * K
    ex_rem = torch.cat([x.ex_rem, torch.zeros((B, S, R), dtype=_F32, device=dev)], 1)
    zeros_i = torch.zeros((B, S), dtype=_I32, device=dev)
    ms.state = dict(
        bi=bi,
        order=torch.cat(orders).long(),
        alpha=torch.cat(alphas), look=torch.cat(looks), rsv=torch.cat(rsvs),
        price_t=torch.cat(price_t),  # [M, T, O]
        slot_rem=ex_rem[bi].clone(),
        slot_opt=torch.full((M, NS), -1, dtype=_I32, device=dev),
        slot_zone=torch.cat([x.ex_zone, zeros_i], 1)[bi].clone(),
        slot_active=torch.cat([x.ex_valid, torch.zeros((B, S), dtype=_BOOL, device=dev)], 1)[bi].clone(),
        slot_bits=torch.cat([x.rel_slot_bits, zeros_i], 1)[bi].clone(),
        sprice=torch.zeros((M, NS), dtype=_F32, device=dev),
        zone_bits=x.rel_zone_bits[bi][:, :Z].clone(),
        scomp=torch.zeros((M, S, _bit_words(G)), dtype=_I32, device=dev),
        unplaced=torch.zeros((M,), dtype=_I32, device=dev),
        exhausted=torch.zeros((M,), dtype=_BOOL, device=dev),
    )


def _member_view(ms: MemberShard, t: int):
    """The step's per-member inputs of the plain version."""
    st = ms.state
    x, sh = ms.inputs, ms.shared
    bi = st["bi"]
    g = st["order"][:, t]
    u = torch.where(st["rsv"][:, None], sh.units_rsv[bi, g], sh.units[bi, g])  # [M, O]
    pe = torch.where(st["look"][:, None], st["price_t"][:, t], x.price[bi])
    return bi, g, u, pe


def _bucket_ok(ms: MemberShard, bi, u):
    Z = ms.dims[6]
    x = ms.inputs
    zidx = torch.arange(Z, dtype=_I32, device=u.device)
    oz = x.opt_zone[bi]  # [M, O]
    opt_bucket_ok = torch.cat([oz[:, None, :] == zidx[None, :, None],
                               torch.ones_like(oz[:, None, :], dtype=_BOOL)], 1)  # [M, Zb, O]
    return opt_bucket_ok & (u > 0)[:, None, :]


def _scores(ms, u, pe, want, okb):
    units_f = u.float()
    safe_u = torch.clamp(u, min=1)[:, None, :]
    wb = want[:, :, None]
    lump = torch.where(okb & (wb > 0), _ceil_div(wb, safe_u).float() * pe[:, None, :], _INF)
    rate = torch.where(okb & (u[:, None, :] <= wb), (pe / torch.clamp(units_f, min=1.0))[:, None, :], _INF)
    return lump, rate


def _local_pick(ms, score, gmin, u, pe, bi):
    """This shard's in-band argmax records for a [M, Zb, O] score and the
    global minima [M, Zb]."""
    st = ms.state
    x = ms.inputs
    G, R = ms.dims[2], ms.dims[5]
    units_f = u.float()
    cand = score <= gmin[..., None] * float(TIE_BAND)
    pref = torch.where(st["alpha"][:, None] >= 1.0, units_f, -units_f)
    vals = torch.where(cand, pref[:, None, :], -_INF)
    idx = torch.argmax(vals, -1)  # [M, Zb]
    v = torch.gather(vals, 2, idx[..., None])[..., 0]
    M, Zb = idx.shape
    rec = torch.empty((M, Zb, _rec_words(R, G)), dtype=_I32, device=u.device)
    rec[..., 0] = _i(v.contiguous())
    rec[..., 1] = (idx + ms.c0).to(_I32)
    rec[..., 2] = torch.gather(u, 1, idx)
    rec[..., 3] = _i(torch.gather(pe, 1, idx).contiguous())
    rec[..., 4] = _i(torch.gather(x.price[bi], 1, idx).contiguous())
    rec[..., 5] = torch.gather(x.opt_zone[bi], 1, idx)
    alloc = x.alloc[bi]  # [M, O, R]
    rec[..., 6:6 + R] = _i(torch.gather(alloc, 1, idx[..., None].expand(M, Zb, R)).contiguous())
    compat = x.compat[bi]  # [M, G, O]
    col = torch.gather(compat, 2, idx[:, None, :].expand(M, G, Zb)).transpose(1, 2)  # [M, Zb, G]
    rec[..., 6 + R:] = _pack_bits(col)
    return rec


def _k2m_fill_ref(ms: MemberShard, t: int) -> None:
    B, K, G, O, E, R, Z = ms.dims
    if t > 0:
        _k2m_apply_ref(ms, t - 1)
    st = ms.state
    x, sh = ms.inputs, ms.shared
    S = ms.s_new
    NS = E + S
    dev = x.demand.device
    bi, g, u, pe = _member_view(ms, t)
    M = bi.shape[0]
    zidx = torch.arange(Z, dtype=_I32, device=dev)
    d = x.demand[bi, g]
    cnt = x.count[bi, g][:, None]
    cap = x.node_cap[bi, g][:, None]
    coloc = x.colocate[bi, g][:, None]
    hf = x.rel_host_forbid[bi, g][:, None]
    hn = x.rel_host_need[bi, g][:, None]
    zf = x.rel_zone_forbid[bi, g][:, None]
    zn = x.rel_zone_need[bi, g][:, None]
    zone_bits = st["zone_bits"]
    zone_rel_ok = ((zone_bits & zf) == 0) & ((zone_bits & zn) == zn)
    q = torch.where(zone_rel_ok, sh.quota[bi, g], 0)
    zl = sh.zone_limited[bi, g][:, None] | (zf != 0) | (zn != 0)
    slot_rem, slot_zone, slot_bits = st["slot_rem"], st["slot_zone"], st["slot_bits"]
    # open fresh slots whose option admits g (its compat column's bit g)
    cols = _unpack_bits(st["scomp"], G)  # [M, S, G]
    comp_new = st["slot_active"][:, E:] & torch.gather(cols, 2, g[:, None, None].expand(M, S, 1))[..., 0]
    comp = torch.cat([sh.exok_pad[bi, g][:, :E], comp_new], 1)
    zb_slot = torch.gather(zone_bits, 1, slot_zone.long())
    rel_ok = (((slot_bits & hf) == 0) & ((slot_bits & hn) == hn)
              & ((zb_slot & zf) == 0) & ((zb_slot & zn) == zn))
    comp = comp & rel_ok
    d_fit = torch.where((st["rsv"] & sh.rsv_group[bi, g])[:, None], x.demand_units[bi, g], d)
    fit = torch.where(comp, torch.minimum(_units(slot_rem, d_fit[:, None, :]), cap), 0)
    zmask = slot_zone[:, None, :] == zidx[None, :, None]
    zfit = torch.where(zmask, fit[:, None, :], 0)
    before_z = _cumsum(zfit, 2) - zfit
    allow = torch.clamp(q[:, :, None] - before_z, min=0)
    fit_q = _isum(torch.where(zmask, torch.minimum(fit[:, None, :], allow), 0), 1)
    fit = torch.where(zl, fit_q, fit)
    fit = torch.where(coloc, torch.where(fit >= cnt, cnt, 0), fit)
    place = torch.minimum(torch.clamp(cnt - (_cumsum(fit, 1) - fit), min=0), fit)
    left = cnt - _isum(place, 1)[:, None]
    st["slot_rem"] = _fma(place.float()[:, :, None], -d[:, None, :], slot_rem)
    placed_z = _isum(torch.where(zmask, place[:, None, :], 0), 2)
    want_z = torch.minimum(torch.clamp(q - placed_z, min=0), left)
    before_w = _cumsum(want_z, 1) - want_z
    want_z = torch.clamp(torch.minimum(want_z, left - before_w), min=0)
    zero_col = torch.zeros((M, 1), dtype=_I32, device=dev)
    want = torch.where(zl, torch.cat([want_z, zero_col], 1),
                       torch.cat([torch.zeros_like(want_z), left], 1))
    want = torch.where(hn == 0, want, 0)
    okb = _bucket_ok(ms, bi, u)
    lump, rate = _scores(ms, u, pe, want, okb)
    st.update(place=place, left=left, want=want, d=d)
    mins = torch.stack([lump.amin(-1), rate.amin(-1)], -1)  # [M, Zb, 2]
    ms.regions[0][ms.self_] = _i(mins.contiguous()).reshape(ms.regions[0].shape[1:])


def _k2m_pick_ref(ms: MemberShard, t: int) -> None:
    st = ms.state
    bi, g, u, pe = _member_view(ms, t)
    M = bi.shape[0]
    gmin = _f(ms.regions[0]).amin(0).reshape(M, -1, 2)
    st["gmin"] = gmin
    okb = _bucket_ok(ms, bi, u)
    lump, rate = _scores(ms, u, pe, st["want"], okb)
    recs = torch.stack([_local_pick(ms, lump, gmin[..., 0], u, pe, bi),
                        _local_pick(ms, rate, gmin[..., 1], u, pe, bi)], 1)  # [M, 2, Zb, RW]
    ms.regions[1][ms.self_] = recs.reshape(ms.regions[1].shape[1:])


def _k2m_tail_ref(ms: MemberShard, t: int) -> None:
    st = ms.state
    bi, g, u, pe = _member_view(ms, t)
    M = bi.shape[0]
    recs = _combine_records(ms.regions[1].reshape((ms.n, M) + ms.regions[1].shape[3:]))
    st["rec_lump"], st["rec_rate"] = recs[:, 0], recs[:, 1]
    want = st["want"]
    c_rate = st["rec_rate"][..., 2]
    n_full = torch.div(want, torch.clamp(c_rate, min=1), rounding_mode="floor")
    rem = want - n_full * c_rate
    okb = _bucket_ok(ms, bi, u)
    rem_k = _ceil_div(rem[:, :, None], torch.clamp(u, min=1)[:, None, :])
    rem_score = torch.where(okb & (rem[:, :, None] > 0), rem_k.float() * pe[:, None, :], _INF)
    st.update(n_full=n_full, rem=rem, c_rate=c_rate, rem_score=rem_score)
    ms.regions[2][ms.self_] = _i(rem_score.amin(-1).contiguous()).reshape(ms.regions[2].shape[1:])


def _k2m_tail_pick_ref(ms: MemberShard, t: int) -> None:
    st = ms.state
    bi, g, u, pe = _member_view(ms, t)
    M = bi.shape[0]
    gmin = _f(ms.regions[2]).amin(0).reshape(M, -1)
    st["tail_best"] = gmin
    rec = _local_pick(ms, st["rem_score"], gmin, u, pe, bi)
    ms.regions[3][ms.self_] = rec.reshape(ms.regions[3].shape[1:])


def _k2m_apply_ref(ms: MemberShard, t: int) -> None:
    """Step t's tail choices, segments and opened slots (run by the fill of
    step t + 1, and by the end for the last step)."""
    B, K, G, O, E, R, Z = ms.dims
    st = ms.state
    x = ms.inputs
    S = ms.s_new
    dev = x.demand.device
    bi = st["bi"]
    M = bi.shape[0]
    rec_tail = _combine_records(ms.regions[3].reshape((ms.n, M) + ms.regions[3].shape[3:]))
    rec_lump, rec_rate = st["rec_lump"], st["rec_rate"]
    want, rem, n_full, c_rate = st["want"], st["rem"], st["n_full"], st["c_rate"]
    cost_lump, best_rate = st["gmin"][..., 0], st["gmin"][..., 1]
    tail_cost = torch.where(rem > 0, st["tail_best"], 0.0)
    pe_rate = _f(rec_rate[..., 3].contiguous())
    cost_mixed = torch.where(best_rate < _INF, _fma(n_full.float(), pe_rate, tail_cost), _INF)
    lump = cost_lump <= cost_mixed
    feasible = (want > 0) & (torch.minimum(cost_lump, cost_mixed) < _INF)
    rec_a = torch.where(lump[..., None], rec_lump, rec_rate)
    segA_c = torch.clamp(rec_a[..., 2], min=1)
    segA_want = torch.where(feasible, torch.where(lump, want, n_full * c_rate), 0)
    segB_c = torch.clamp(rec_tail[..., 2], min=1)
    segB_want = torch.where(feasible & ~lump, rem, 0)
    seg_rec = torch.cat([rec_a, rec_tail], 1)  # [M, 2Zb, RW]
    seg_c = torch.cat([segA_c, segB_c], 1)
    seg_want = torch.cat([segA_want, segB_want], 1)
    seg_n = _ceil_div(seg_want, seg_c)
    seg_start = _cumsum(seg_n, 1) - seg_n
    total_open = _isum(seg_n, 1)[:, None]
    is_new = ms.shared.is_new[0][None, :]
    slot_active = st["slot_active"]
    free = is_new & ~slot_active
    fr = _cumsum(free.to(_I32), 1)
    take = free & (fr <= total_open)
    r0 = fr - 1
    sid = _isum((r0[:, :, None] >= seg_start[:, None, :]).to(_I32), 2) - 1
    sid = sid.clamp(0, seg_n.shape[1] - 1).long()
    rec_i = torch.gather(seg_rec, 1, sid[..., None].expand(sid.shape + (seg_rec.shape[-1],)))
    c_i = torch.gather(seg_c, 1, sid)
    pos_i = r0 - torch.gather(seg_start, 1, sid)
    fill = torch.where(
        take, torch.minimum(torch.clamp(torch.gather(seg_want, 1, sid) - pos_i * c_i, min=0), c_i), 0
    )
    opened = _isum(fill, 1)[:, None]
    d = st["d"]
    alloc_i = _f(rec_i[..., 6:6 + R].contiguous())
    st["slot_rem"] = torch.where(take[:, :, None], _fma(fill.float()[:, :, None], -d[:, None, :], alloc_i),
                                 st["slot_rem"])
    st["slot_opt"] = torch.where(take, rec_i[..., 1], st["slot_opt"])
    st["slot_zone"] = torch.where(take, rec_i[..., 5], st["slot_zone"])
    st["sprice"] = torch.where(take, _f(rec_i[..., 4].contiguous()), st["sprice"])
    st["scomp"] = torch.where(take[:, E:, None], rec_i[:, E:, 6 + R:], st["scomp"])
    st["slot_active"] = slot_active | take
    left = st["left"] - opened
    st["unplaced"] = st["unplaced"] + left[:, 0]
    st["exhausted"] = st["exhausted"] | ((left[:, 0] > 0) & (total_open[:, 0] > _isum(free.to(_I32), 1)))
    yt = st["place"] + fill
    ms.ys.view(M, G, -1)[:, t] = yt
    sm = x.rel_set[bi, st["order"][:, t]][:, None]
    st["slot_bits"] = torch.where(yt > 0, st["slot_bits"] | sm, st["slot_bits"])
    zidx = torch.arange(Z, dtype=_I32, device=dev)
    zmask2 = st["slot_zone"][:, None, :] == zidx[None, :, None]
    zplaced2 = _isum(torch.where(zmask2, yt[:, None, :], 0), 2)
    st["zone_bits"] = torch.where(zplaced2 > 0, st["zone_bits"] | sm, st["zone_bits"])


def _k2m_end_ref(ms: MemberShard) -> MemberOut:
    B, K, G, O, E, R, Z = ms.dims
    _k2m_apply_ref(ms, G - 1)
    st = ms.state
    new_opt = st["slot_opt"][:, E:].contiguous()
    new_active = st["slot_active"][:, E:] & (new_opt >= 0)
    node_prices = torch.where(new_active, st["sprice"][:, E:], 0.0)
    cost = _fma(st["unplaced"].float(), float(UNPLACED_PENALTY), node_prices.sum(1))
    S = new_opt.shape[1]
    return MemberOut(cost.view(B, K), st["unplaced"].view(B, K), st["exhausted"].view(B, K),
                     new_opt.view(B, K, S), new_active.view(B, K, S), ms.ys)


_STAGE_REFS = (_k2m_fill_ref, _k2m_pick_ref, _k2m_tail_ref, _k2m_tail_pick_ref)


# ---------------------------------------------------------------------------
# The cross-shard member argmin (1D mesh): plain versions
# ---------------------------------------------------------------------------

def _argmin_before(v2: float, i2: int, v: float, i: int) -> bool:
    """(v2, i2) before (v, i) under jnp.argmin: the first NaN, else the
    lowest value, the lower index on ties."""
    nan2, nan = v2 != v2, v != v
    if nan2 != nan:
        return nan2
    return i2 < i if nan2 else (v2 < v or (v2 == v and i2 < i))


def mesh_seed_ref(costs, orders, alphas, looks, rsvs, swaps: torch.Tensor):
    """The seed over every shard's phase-1 members (``costs[s]``,
    ``orders[s]``, ... : shard s's ``[B, kl, ...]``, its members the global
    members s kl .. (s + 1) kl - 1) by ``torch.argmin`` over the whole
    portfolio (the first NaN, else the first minimum), and this shard's
    phase-2 members: ``orders2[k] = seed_order[swaps[k]]`` under the seed's
    alpha, look and rsv. Returns ``(orders2, alphas2, looks2, rsvs2, b1)``."""
    dev = swaps.device
    cat = lambda xs: torch.cat([x.to(dev) for x in xs], 1)  # noqa: E731
    cost, order, alpha, look, rsv = map(cat, (costs, orders, alphas, looks, rsvs))
    B, kl, G = swaps.shape
    j = torch.argmin(cost, 1)  # [B]
    rows = torch.arange(B, device=dev)
    seed = order[rows, j]  # [B, G]
    expand = lambda x: x[rows, j][:, None].expand(B, kl).contiguous()  # noqa: E731
    return (torch.gather(seed[:, None, :].expand(B, kl, G), 2, swaps.long()),
            expand(alpha), expand(look), expand(rsv), j.to(_I32)[:, None])


def final_pick_ref(bufs: Sequence[torch.Tensor], b1: torch.Tensor, kl: int) -> torch.Tensor:
    """The fused buffer of the whole portfolio from every shard's K3 buffer
    (``bufs[s]``, ``[B, L_local]`` over ``kl`` members each): the winner over
    the 2K costs by jnp.argmin's rule, the global seed ``b1``, the costs and
    flags in global member order, and the winner's rows."""
    bufs = torch.stack([x.to(b1.device) for x in bufs])
    n, B, Ll = bufs.shape
    K = n * kl
    tail = Ll - 4 - 4 * kl
    out = torch.empty((B, 4 + 4 * K + tail), dtype=_I32, device=bufs.device)
    for b in range(B):
        best, bv, bi = 0, 0.0, None
        for s in range(n):
            ph, bk = int(bufs[s, b, 0]), int(bufs[s, b, 2])
            v = float(_f(bufs[s, b, 4 + ph * kl + bk : 5 + ph * kl + bk].contiguous())[0])
            gi = ph * K + s * kl + bk
            if bi is None or _argmin_before(v, gi, bv, bi):
                best, bv, bi = s, v, gi
        w = bufs[best, b]
        ph = int(w[0])
        out[b, 0] = ph
        out[b, 1] = b1[b, 0]
        out[b, 2] = best * kl + int(w[2])
        out[b, 3] = w[3]
        for p in range(2):
            for s in range(n):
                lo = 4 + p * K + s * kl
                out[b, lo : lo + kl] = bufs[s, b, 4 + p * kl : 4 + (p + 1) * kl]
                lo = 4 + 2 * K + p * K + s * kl
                out[b, lo : lo + kl] = bufs[s, b, 4 + 2 * kl + p * kl : 4 + 2 * kl + (p + 1) * kl]
        out[b, 4 + 4 * K :] = w[4 + 4 * kl :]
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------

def _plain(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its plain version: for tensors on the CPU."""
    return t.device.type == "cpu"


def _lib():
    from ._build import load_kernels

    return load_kernels()


def k1_tiles(O: int, device) -> int:
    """Columns of K1's partials for O option columns: k1_units' tiles on the
    card, one for the plain version."""
    if _plain(torch.empty(0, device=device)):
        return 1
    return int(_lib().kts_k1_tiles(O))


def shard_precompute_part(inputs: PackInputs, s_new: int, part: torch.Tensor) -> ShardPart:
    """K1's part on one option shard (``[B, ...]`` inputs of its columns):
    ``k1_units`` over the columns, its partials into ``part``."""
    if _plain(inputs.demand):
        return shard_precompute_part_ref(inputs, s_new, part)
    ts._check_inputs(inputs, inputs.rel_zone_bits.shape[-1])
    return _launch_shard_precompute_part(_lib(), inputs, s_new, part, ts._stream())


def _launch_shard_precompute_part(lib, inputs: PackInputs, s_new: int, part, stream) -> ShardPart:
    B = inputs.demand.shape[0]
    G, O, E, R, Z = ts._dims(inputs)
    dev = inputs.demand.device
    sp = ShardPart(
        units=torch.empty((B, G, O), dtype=_I32, device=dev),
        units_rsv=torch.empty((B, G, O), dtype=_I32, device=dev),
        rsv_group=torch.empty((B, G), dtype=_BOOL, device=dev),
        zone_limited=torch.empty((B, G), dtype=_BOOL, device=dev),
        exok_pad=torch.empty((B, G, E + s_new), dtype=_BOOL, device=dev),
        is_new=torch.empty((B, E + s_new), dtype=_BOOL, device=dev),
    )
    rc = lib.kts_k1_part(
        ts._ptr(inputs.demand), ts._ptr(inputs.demand_units), ts._ptr(inputs.count),
        ts._ptr(inputs.node_cap), ts._ptr(inputs.quota), ts._ptr(inputs.colocate),
        ts._ptr(inputs.compat), ts._ptr(inputs.alloc), ts._ptr(inputs.price),
        ts._ptr(inputs.opt_valid), ts._ptr(inputs.ex_compat), ts._ptr(inputs.ex_valid),
        ts._ptr(sp.units), ts._ptr(sp.units_rsv), ts._ptr(sp.rsv_group), ts._ptr(sp.zone_limited),
        ts._ptr(sp.exok_pad), ts._ptr(sp.is_new), ts._ptr(part),
        B, G, O, E, R, Z, s_new, stream,
    )
    _count("shard_precompute_part")
    ts._raise_on(lib, rc, "shard_precompute_part")
    return sp


def shard_precompute_finish(inputs: PackInputs, sp: ShardPart, parts: Sequence[torch.Tensor]) -> Shared:
    """K1's finish on one option shard, one launch: ``k1_val_pair`` over
    the columns, reducing every shard's partials (``parts[s]``, read in
    place through its table)."""
    if _plain(inputs.demand):
        return shard_precompute_finish_ref(inputs, sp, parts)
    return _launch_shard_precompute_finish(_lib(), inputs, sp, parts, ts._stream())


def _table(tensors) -> ctypes.Array:
    """Device pointers of ``tensors`` as a C array (a kernel's table)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_table(what: str, tensors, dtype, shape: tuple) -> None:
    """The buffers a table names: each contiguous, of ``dtype`` and ``shape``."""
    for t in tensors:
        if t.dtype is not dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{what}: a buffer of {t.dtype} {tuple(t.shape)}"
                             f"{'' if t.is_contiguous() else ', not contiguous'}; expected {dtype} "
                             f"{shape}, contiguous")


def _launch_shard_precompute_finish(lib, inputs: PackInputs, sp: ShardPart, parts, stream) -> Shared:
    B = inputs.demand.shape[0]
    G, O, E, R, Z = ts._dims(inputs)
    NS = sp.exok_pad.shape[-1]
    dev = inputs.demand.device
    _check_table("shard_precompute_finish", parts, _I32, (2, B, G, int(lib.kts_k1_tiles(O))))
    lam = torch.empty((B, G), dtype=_F32, device=dev)
    val_pair = torch.empty((B, G, O, G), dtype=_F32, device=dev)
    rc = lib.kts_k1_finish(
        ts._ptr(inputs.demand), ts._ptr(inputs.demand_units), ts._ptr(inputs.count),
        ts._ptr(inputs.node_cap), ts._ptr(inputs.colocate), ts._ptr(inputs.compat),
        ts._ptr(inputs.alloc), ts._ptr(inputs.opt_valid),
        ts._ptr(sp.units), ts._ptr(sp.units_rsv), ts._ptr(lam), ts._ptr(val_pair),
        _table(parts), len(parts), B, G, O, E, R, Z, NS - E, stream,
    )
    _count("shard_precompute_finish")
    ts._raise_on(lib, rc, "shard_precompute_finish")
    return Shared(sp.units, sp.units_rsv, sp.rsv_group, lam, inputs.quota, sp.zone_limited,
                  val_pair, sp.exok_pad, sp.is_new)


def _k2m_args(ms: MemberShard):
    """``kts_k2m``'s arguments for a shard: its pointers, in ``K2MArgs``'
    order with the regions' bases (0 for none), and B K G O E R Z S c0 n
    self."""
    x, sh = ms.inputs, ms.shared
    B, K, G, O, E, R, Z = ms.dims
    ptrs = [
        x.demand, x.demand_units, x.count, x.node_cap, x.colocate, x.compat, x.alloc, x.price,
        x.opt_zone, x.ex_rem, x.ex_zone, x.ex_valid, x.rel_set, x.rel_host_forbid,
        x.rel_host_need, x.rel_zone_forbid, x.rel_zone_need, x.rel_slot_bits, x.rel_zone_bits,
        sh.units, sh.units_rsv, sh.rsv_group, sh.quota, sh.zone_limited, sh.val_pair, sh.exok_pad,
        ms.orders, ms.alphas, ms.looks, ms.rsvs, ms.swaps if ms.seed_costs is not None else None,
        ms.seed_costs, ms.state["price_t"], ms.state["bytes"], *ms.regions, ms.ys,
        ms.state["cost"], ms.state["unplaced"], ms.state["exhausted"], ms.state["new_opt"],
        ms.state["new_active"],
    ]
    return ([0 if p is None else p.data_ptr() for p in ptrs],
            [B, K, G, O, E, R, Z, ms.s_new, ms.c0, ms.n, ms.self_])


def _c_arrays(ptrs, ints):
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints)


def _state_bytes(lib, dims, s_new: int) -> int:
    B, K, G, O, E, R, Z = dims
    return int(lib.kts_k2m_state_bytes(G, O, E, R, Z, s_new))


def shard_member_begin(ms: MemberShard) -> None:
    """Start a meshed K2 phase on one shard: the member configs and scan
    orders, the lookahead prices of the shard's columns, the slot state."""
    if _plain(ms.inputs.demand):
        _k2m_begin_ref(ms)
        return
    ts._check_inputs(ms.inputs, ms.dims[6])
    _launch_shard_member(_lib(), ms, -1, 0, ts._stream())


def shard_member_step(ms: MemberShard, stage: int, t: int) -> None:
    """One stage (``STAGES``) of step t of a meshed K2 phase on one shard;
    its output lands in ``ms.regions[stage][self]``."""
    if _plain(ms.inputs.demand):
        _STAGE_REFS[stage](ms, t)
        return
    _launch_shard_member(_lib(), ms, stage, t, ts._stream())


def shard_member_end(ms: MemberShard) -> MemberOut:
    """The phase's member results (replicated: every shard of a column
    computes the same)."""
    if _plain(ms.inputs.demand):
        return _k2m_end_ref(ms)
    _launch_shard_member(_lib(), ms, len(STAGES), 0, ts._stream())
    return _member_out(ms)


def _member_out(ms: MemberShard) -> MemberOut:
    st = ms.state
    return MemberOut(st["cost"], st["unplaced"], st["exhausted"], st["new_opt"], st["new_active"], ms.ys)


def _launch_shard_member(lib, ms: MemberShard, stage: int, t: int, stream) -> None:
    """stage -1 starts the phase, 0..3 run a step's stage, len(STAGES) ends
    it; the regions' other rows are this shard's copies (``_all_gather``)."""
    rc = lib.kts_k2m(*_c_arrays(*_k2m_args(ms)), stage, t, stream)
    _count("shard_member")
    ts._raise_on(lib, rc, f"shard_member stage {stage}")


# ---------------------------------------------------------------------------
# The phase entry: one library call a phase (``kts_k2m_phase``)
# ---------------------------------------------------------------------------

#: How a phase on the card is issued: "entry", one call of the phase entry
#: (the main path), or "stages", the per-stage issue from Python
#: (``shard_member_step`` and ``_all_gather``), which only comparisons take
PHASE_MODE = "entry"
#: phases each way ran on the card
PHASE_PATHS = {"entry": 0, "stages": 0}


def phase_launches(n: int, G: int) -> int:
    """What one phase adds to ``LAUNCHES["shard_member"]``: each shard's
    begin and end, and ``STAGES`` a step."""
    return n * (len(STAGES) * G + 2)


def _phase_buffers(lib, shards, dims, s_new: int) -> list:
    """Each shard's phase buffers on its card and stream: its own ys, state
    and results, and the exchange regions, which the shards share where
    ``_shared_regions`` says so (the first shard's)."""
    n, regions, bufs = len(shards), None, []
    shared = _shared_regions(shards)
    for s, sh in enumerate(shards):
        with _on(sh):
            bufs.append(_member_buffers(dims[s], s_new, n, sh.device, _state_bytes(lib, dims[s], s_new),
                                        regions))
        if shared:
            regions = bufs[0]["regions"]
    return bufs


def _shared_regions(shards) -> bool:
    """Whether the shards share memory: on one card, or on cards that all
    have peer access to each other. A K2 phase's shards then share one copy
    of the exchange regions, and K1's finish and the member argmin read the
    other shards' buffers in place; else each shard holds its own copy of
    the regions, the exchanges copy rows between them, and ``_read_from``
    copies what a kernel reads."""
    cards = {_device_index(sh) for sh in shards}
    return len(cards) == 1 or all(torch.cuda.can_device_access_peer(a, b)
                                  for a in cards for b in cards if a != b)


def _device_index(sh: _Shard) -> int:
    """The shard's card (0 for a CPU shard)."""
    if sh.device.type != "cuda":
        return 0
    return torch.cuda.current_device() if sh.device.index is None else sh.device.index


def _issue_phase(lib, shards, mss) -> List[MemberOut]:
    """The phase in one call of the phase entry, which counts the launches
    it made into ``LAUNCHES["shard_member"]``."""
    n = len(mss)
    ptrs, dims = [], []
    for ms in mss:
        ts._check_inputs(ms.inputs, ms.dims[6])
        p, d = _k2m_args(ms)
        ptrs += p
        dims += d
    ptrs, dims = _c_arrays(ptrs, dims)
    devices = (ctypes.c_int * n)(*(_device_index(sh) for sh in shards))
    streams = (ctypes.c_void_p * n)(*(0 if sh.stream is None else sh.stream.cuda_stream for sh in shards))
    launches = ctypes.c_longlong(0)
    rc = lib.kts_k2m_phase(n, ptrs, dims, devices, streams, ctypes.byref(launches))
    with ts._COUNT_LOCK:
        LAUNCHES["shard_member"] += launches.value
        PHASE_PATHS["entry"] += rc == 0
    ts._raise_on(lib, rc, "shard_member phase")
    return [_member_out(ms) for ms in mss]


def _issue_stages(shards, mss) -> List[MemberOut]:
    """The phase stage by stage from Python: each shard's begin, the G steps
    of ``STAGES`` with an exchange (``_all_gather``) after each, each
    shard's end. The plain versions' path, and on the card the per-stage
    issue that the phase entry replaced."""
    G = mss[0].dims[2]
    for sh, ms in zip(shards, mss):
        with _on(sh):
            shard_member_begin(ms)
    for t in range(G):
        for stage in range(len(STAGES)):
            for sh, ms in zip(shards, mss):
                with _on(sh):
                    shard_member_step(ms, stage, t)
            _all_gather(shards, [ms.regions[stage] for ms in mss])
    out = []
    for sh, ms in zip(shards, mss):
        with _on(sh):
            out.append(shard_member_end(ms))
    return out


def mesh_seed(costs, orders, alphas, looks, rsvs, swaps: torch.Tensor):
    """The member argmin's seed on one shard, one launch: the seed over
    every shard's phase-1 members (``costs[s]``, ``orders[s]``, ... read in
    place through its table) and this shard's phase-2 member arrays."""
    if _plain(swaps):
        return mesh_seed_ref(costs, orders, alphas, looks, rsvs, swaps)
    lib = _lib()
    B, kl, G = swaps.shape
    n = len(costs)
    for what, xs, dtype, shape in (("cost", costs, _F32, (B, kl)), ("orders", orders, _I32, (B, kl, G)),
                                   ("alphas", alphas, _F32, (B, kl)), ("looks", looks, _BOOL, (B, kl)),
                                   ("rsvs", rsvs, _BOOL, (B, kl)), ("swaps", (swaps,), _I32, (B, kl, G))):
        _check_table(f"member_argmin (seed) {what}", xs, dtype, shape)
    dev = swaps.device
    orders2 = torch.empty((B, kl, G), dtype=_I32, device=dev)
    alphas2 = torch.empty((B, kl), dtype=_F32, device=dev)
    looks2 = torch.empty((B, kl), dtype=_BOOL, device=dev)
    rsvs2 = torch.empty((B, kl), dtype=_BOOL, device=dev)
    b1 = torch.empty((B, 1), dtype=_I32, device=dev)
    members = _table([t for s in range(n) for t in (costs[s], orders[s], alphas[s], looks[s], rsvs[s])])
    rc = lib.kts_mesh_seed(members, ts._ptr(swaps), ts._ptr(orders2), ts._ptr(alphas2), ts._ptr(looks2),
                           ts._ptr(rsvs2), ts._ptr(b1), n, B, kl, G, ts._stream())
    _count("member_argmin")
    ts._raise_on(lib, rc, "member_argmin (seed)")
    return orders2, alphas2, looks2, rsvs2, b1


def final_pick(bufs: Sequence[torch.Tensor], b1: torch.Tensor, kl: int) -> torch.Tensor:
    """The member argmin over the 2K costs on the root, one launch: the
    whole portfolio's fused buffer from every shard's K3 buffer
    (``bufs[s]``, read in place through its table)."""
    if _plain(b1):
        return final_pick_ref(bufs, b1, kl)
    lib = _lib()
    n = len(bufs)
    B, Ll = bufs[0].shape
    _check_table("member_argmin (final)", bufs, _I32, (B, Ll))
    out = torch.empty((B, Ll + 4 * kl * (n - 1)), dtype=_I32, device=b1.device)
    rc = lib.kts_final_pick(_table(bufs), ts._ptr(b1), ts._ptr(out), n, B, Ll, kl, ts._stream())
    _count("member_argmin")
    ts._raise_on(lib, rc, "member_argmin (final)")
    return out


# ---------------------------------------------------------------------------
# The chains
# ---------------------------------------------------------------------------

def _shard_leaves(placed, i: int):
    return type(placed)(*(p.shards[i] for p in placed))


def _batched(x: PackInputs) -> PackInputs:
    return x if x.demand.dim() == 3 else ts._unsqueeze(x)


def _portfolio_chain(shards, inputs, members, s_new: int, n_zones: int) -> torch.Tensor:
    """The 1D mesh over members: ``inputs[s]`` whole on shard s,
    ``members[s]`` its K/n members (``[B, K/n, ...]``). The member argmin
    reads the shards' phase-1 members and K3 buffers where they lie
    (``_read_from``, which records each on the stream that reads it)."""
    n = len(shards)
    kl = members[0][0].shape[1]
    shared_mem = _shared_regions(shards)
    shared, m1 = [None] * n, [None] * n
    for s, sh in enumerate(shards):
        with _on(sh):
            orders, alphas, looks, rsvs, _ = members[s]
            shared[s] = ts.shared_precompute(inputs[s], s_new, n_zones)
            m1[s] = ts.pack_member(inputs[s], shared[s], orders, alphas, looks, rsvs, s_new, n_zones)
    _record(shards)
    phase1 = [(m1[s].cost,) + tuple(members[s][:4]) for s in range(n)]
    bufs, b1 = [], None
    for s, sh in enumerate(shards):
        seen = _read_from(sh, shards, phase1, shared_mem, "member_argmin")
        with _on(sh):
            o2, a2, l2, r2, b1_s = mesh_seed(*zip(*seen), members[s][4])
            m2 = ts.pack_member(inputs[s], shared[s], o2, a2, l2, r2, s_new, n_zones)
            bufs.append(ts.pack_epilogue(m1[s], m2))
            b1 = b1_s if s == 0 else b1
    _record(shards)
    root = shards[0]
    seen = _read_from(root, shards, [(b,) for b in bufs], shared_mem, "member_argmin")
    with _on(root):
        return final_pick([b for b, in seen], b1, kl)


def shard_precompute_all(shards, inputs, s_new: int) -> List[Shared]:
    """K1 over an option split: each shard's part, then each shard's
    finish, which reads every shard's partials where they lie
    (``_read_from``)."""
    B, G = inputs[0].demand.shape[:2]
    O = inputs[0].price.shape[-1]
    parts, sps = [], []
    for s, sh in enumerate(shards):
        with _on(sh):
            parts.append(torch.empty((2, B, G, k1_tiles(O, sh.device)), dtype=_I32, device=sh.device))
            sps.append(shard_precompute_part(inputs[s], s_new, parts[s]))
    _record(shards)
    shared_mem = _shared_regions(shards)
    shared = []
    for s, sh in enumerate(shards):
        seen = _read_from(sh, shards, [(p,) for p in parts], shared_mem, "shard_precompute_finish")
        with _on(sh):
            shared.append(shard_precompute_finish(inputs[s], sps[s], [p for p, in seen]))
    return shared


def shard_member_phase(shards, inputs, shared, members, s_new: int,
                       seed_costs=None) -> List[MemberOut]:
    """One phase of K2 over an option split: each shard's begin, the G steps
    of four stages with an exchange after each, each shard's end.
    ``seed_costs[s]`` (phase 2) holds the phase-1 costs on shard s. On CPU
    tensors the plain versions run stage by stage; on the card one call of
    the phase entry issues the whole phase (``_issue_phase``)."""
    n = len(shards)
    O = inputs[0].price.shape[-1]
    plain = _plain(inputs[0].demand)
    lib = None if plain else _lib()

    def member(s, bufs=None):
        orders, alphas, looks, rsvs, swaps = members[s]
        return MemberShard(inputs[s], shared[s], orders, alphas, looks, rsvs, swaps,
                           None if seed_costs is None else seed_costs[s], s_new, s * O, n, s, bufs)

    if plain:
        mss = []
        for s, sh in enumerate(shards):
            with _on(sh):
                mss.append(member(s))
        return _issue_stages(shards, mss)
    dims = [_member_dims(inputs[s], members[s][0]) for s in range(n)]
    mss = [member(s, b) for s, b in enumerate(_phase_buffers(lib, shards, dims, s_new))]
    if PHASE_MODE == "stages":
        with ts._COUNT_LOCK:
            PHASE_PATHS["stages"] += 1
        return _issue_stages(shards, mss)
    return _issue_phase(lib, shards, mss)


def _options_chain(shards, inputs, members, s_new: int, n_zones: int) -> torch.Tensor:
    """The 2D mesh's option split over one fleet column: ``inputs[s]`` holds
    shard s's option columns (``[B, ...]``), ``members`` the replicated
    member arrays of each shard."""
    shared = shard_precompute_all(shards, inputs, s_new)
    m1 = shard_member_phase(shards, inputs, shared, members, s_new)
    m2 = shard_member_phase(shards, inputs, shared, members, s_new, [m.cost for m in m1])
    with _on(shards[0]):
        return ts.pack_epilogue(m1[0], m2[0])


def _record_inputs(shards, leaves) -> None:
    """The caller's resident tensors are read on the shards' streams: keep
    the allocator from reusing their memory before those streams are done."""
    for sh in shards:
        if sh.stream is None:
            continue
        for p in leaves:
            p.shards[sh.index].record_stream(sh.stream)


def _join(shards, caller) -> None:
    """Every shard's stream and the caller's after all of the chain's work."""
    if shards[0].stream is None:
        return
    for s in shards:
        s.event.record(s.stream)
    for s in shards:
        for o in shards:
            if o is not s:
                s.stream.wait_event(o.event)
        caller.wait_event(s.event)


def solve_meshed(mesh, inputs, orders, alphas, looks, rsvs, swaps, s_new: int,
                 n_zones: int) -> torch.Tensor:
    """``torch_solver.pack_solve_meshed``: see the module docstring."""
    from ..parallel.mesh import FLEET_AXIS, OPTIONS_AXIS, PORTFOLIO_AXIS, is_mesh2d

    leaves = list(inputs) + [orders, alphas, looks, rsvs, swaps]
    batched = len(inputs.demand.shape) == 3
    B = inputs.demand.shape[0] if batched else 1
    all_shards = [_Shard(mesh, i) for i in range(mesh.size)]
    root = all_shards[0]
    caller = torch.cuda.current_stream(root.device) if root.stream is not None else None
    if caller is not None:
        for sh in all_shards:
            sh.stream.wait_stream(caller)
    _record_inputs(all_shards, leaves)
    members_of = lambda i: tuple(  # noqa: E731
        m.shards[i] if batched else m.shards[i].unsqueeze(0)
        for m in (orders, alphas, looks, rsvs, swaps))
    inputs_of = lambda i: _batched(_shard_leaves(inputs, i))  # noqa: E731

    if not is_mesh2d(mesh):
        if not batched and orders.spec[:1] == (PORTFOLIO_AXIS,):
            buf = _portfolio_chain(all_shards, [inputs_of(i) for i in range(mesh.size)],
                                   [members_of(i) for i in range(mesh.size)], s_new, n_zones)[0]
        elif batched and inputs.demand.spec[:1] == (PORTFOLIO_AXIS,):
            bufs = []
            for i, sh in enumerate(all_shards):
                with _on(sh):
                    bufs.append(ts.pack_solve_fused(inputs_of(i), *members_of(i), s_new, n_zones))
            with _on(root):
                out = torch.empty((len(bufs),) + tuple(bufs[0].shape), dtype=_I32, device=root.device)
            _gather_to(root, all_shards, bufs, out)
            buf = out.reshape(B, -1)
        else:
            # a replicated placement: the first shard computes it
            with _on(root):
                buf = ts.pack_solve_fused(inputs_of(0), *members_of(0), s_new, n_zones)
                buf = buf if batched else buf[0]
        _join(all_shards, caller)
        return buf

    MO, MF = mesh.shape[OPTIONS_AXIS], mesh.shape[FLEET_AXIS]
    split_rows = batched and inputs.demand.spec[:1] == (FLEET_AXIS,)
    split_opts = inputs.price.spec[-1:] == (OPTIONS_AXIS,)
    cols = range(MF) if split_rows else range(1)
    col_bufs, col_roots = [], []
    for f in cols:
        ids = [o * MF + f for o in range(MO)] if split_opts else [f]
        shards = [all_shards[i] for i in ids]
        ins = [inputs_of(i) for i in ids]
        mem = [members_of(i) for i in ids]
        if len(shards) == 1:
            with _on(shards[0]):
                col_bufs.append(ts.pack_solve_fused(ins[0], *mem[0], s_new, n_zones))
        else:
            col_bufs.append(_options_chain(shards, ins, mem, s_new, n_zones))
        col_roots.append(shards[0])
    if len(col_bufs) == 1:
        buf = col_bufs[0]
    else:
        with _on(root):
            out = torch.empty((len(col_bufs),) + tuple(col_bufs[0].shape), dtype=_I32,
                              device=root.device)
        _gather_to(root, col_roots, col_bufs, out)
        buf = out.reshape(B, -1)
    _join(all_shards, caller)
    return buf if batched else buf[0]
