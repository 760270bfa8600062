"""Ring attention: exact attention over a sequence sharded across slots.

The counterpart of ``zest_tpu/parallel/ring.py``. The sequence is cut
into P blocks, one a slot of a slot mesh's ``seq`` axis; each slot keeps
its query block and folds every key/value block into a numerically
stable streaming softmax (the blockwise/flash recurrence) while the K/V
blocks rotate slot to slot: after ``s`` rotations slot ``i`` holds the
block that started on slot ``(i - s) mod P``. A rotation is an explicit
``.to(next_slot_device)``, so autograd's backward of the ring is the
reverse ring. Peak score memory per slot is O(T/P · T/P) instead of
O(T²).

The JAX package runs one program per device under ``shard_map``; here
one process holds its slots' blocks in a list (slot order along the
axis) and runs the ring's steps slot by slot: :func:`ring_self_attention`
takes those lists, :func:`ring_attention` cuts global (B, T, H, D) arrays
over a mesh axis and joins the result. On a ``{data, seq, model}`` grid
(Llama's TP×CP) each ``(data, model)`` row of seq slots runs its own ring
over that ``model`` slot's local heads, under the same shapes contract.

A ring whose slots span processes (a :class:`Ring` naming each block's
place and process) moves a block across a process boundary with one
``torch.distributed`` send and receive a step, K and V together
(``parallel/sends.exchange``, whose backward sends the gradients back);
within a process it stays a ``.to``.

Masking is the reference's exactly: causality by global positions (block
index × block length + offset), whole future blocks at -inf; a row that
has seen only masked keys keeps its running max at -inf and subtracts 0
instead (``safe_m``), its rescale factor ``alpha`` is 0, so every exp and
its derivative stay finite.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from zest_tpu_torch.parallel import sends
from zest_tpu_torch.parallel.mesh import host_index, world_size

SEQ_AXIS = "seq"

_NEG_INF = float("-inf")


def _accumulate(acc, qf, kb, vb, qpos, kpos0: int, causal: bool):
    """Fold one K/V block (B, Tk, Hkv, D) into the running (m, l, o) of
    the float32, pre-scaled query block ``qf`` (B, Tq, H, D); ``kpos0`` is
    the block's global start."""
    m, l, o = acc
    H, Hkv = qf.shape[2], kb.shape[2]
    kk, vv = kb.float(), vb.float()
    if Hkv != H:  # GQA: each kv head serves its query group
        kk = kk.repeat_interleave(H // Hkv, dim=2)
        vv = vv.repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kk)
    if causal:
        kpos = kpos0 + torch.arange(kb.shape[1], device=qf.device)
        scores = scores.masked_fill(kpos[None, :] > qpos[:, None], _NEG_INF)
    new_m = torch.maximum(m, scores.amax(dim=-1))             # (B, H, Tq)
    # Fully masked so far: new_m is -inf; subtract 0 instead so the exps
    # stay NaN-free (the scores are -inf there, giving p = 0).
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    p = torch.exp(scores - safe_m[..., None])                 # (B,H,Tq,Tk)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    upd = torch.einsum("bhqk,bkhd->bhqd", p, vv)
    return new_m, l * alpha + p.sum(dim=-1), o * alpha[..., None] + upd


@dataclasses.dataclass(frozen=True)
class Ring:
    """Where a ring's blocks live: ``positions[i]`` is the ring position
    of this process's ``i``-th block, ``ranks[p]`` the process holding
    position ``p`` (the ring's length is ``len(ranks)``)."""

    positions: tuple[int, ...]
    ranks: tuple[int, ...]

    @classmethod
    def local(cls, n: int) -> "Ring":
        """``n`` blocks, all in this process."""
        return cls(tuple(range(n)), (host_index(),) * n)

    @classmethod
    def over(cls, mesh, slots: list[int]) -> "Ring":
        """The ring along ``slots`` (a mesh axis's slots in axis order),
        each held by its slot's process."""
        per = len(mesh.local_slots())
        return cls(tuple(p for p, s in enumerate(slots)
                         if mesh.devices.flat[s] is not None),
                   tuple(s // per for s in slots))


def _rotate(blocks: list, ring: Ring, devices: list) -> list:
    """One step of the ring: position ``p`` takes the block of position
    ``p - 1``, by ``.to`` within this process, else by one exchange with
    the neighbouring processes."""
    size = len(ring.ranks)
    index = {p: i for i, p in enumerate(ring.positions)}
    out: list = [None] * len(blocks)
    out_pos, like, srcs = [], [], []
    for i, p in enumerate(ring.positions):
        j = index.get((p - 1) % size)
        if j is not None:
            out[i] = blocks[j].to(devices[i])
        else:
            out_pos.append(i)
            like.append((blocks[i].shape, blocks[i].dtype, devices[i]))
            srcs.append(ring.ranks[(p - 1) % size])
    if not out_pos:
        return out
    base = sends.next_tags()
    outgoing = [(blocks[i], ring.ranks[(p + 1) % size], base + (p + 1) % size)
                for i, p in enumerate(ring.positions)
                if (p + 1) % size not in index]
    got = sends.exchange([b for b, _, _ in outgoing],
                         [r for _, r, _ in outgoing],
                         [t for _, _, t in outgoing], like, srcs,
                         [base + ring.positions[i] for i in out_pos])
    for i, t in zip(out_pos, got):
        out[i] = t
    return out


def ring_self_attention(qs: list, ks: list, vs: list, *, causal: bool = True,
                        scale: float | None = None,
                        ring: Ring | None = None) -> list:
    """Exact (optionally causal) attention over a ring of sequence blocks.

    ``qs``, ``ks``, ``vs``: one block a slot, in slot order along the
    sequence axis, each on its slot's device: ``q`` (B, Tq, H, D), ``k``
    and ``v`` (B, Tk, Hkv, D); GQA needs H a multiple of Hkv. With
    ``ring`` the lists hold this process's blocks only, at the ring
    positions it names (every process of the ring calls this at once).
    Returns the (B, Tq, H, D) output blocks in ``q``'s dtype, each on its
    slot's device. Scores and the softmax are float32."""
    ring = ring if ring is not None else Ring.local(len(qs))
    size = len(ring.ranks)
    B, Tq, H, D = qs[0].shape
    Tk, Hkv = ks[0].shape[1], ks[0].shape[2]
    if H % Hkv:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    devices = [q.device for q in qs]
    qfs = [q.float() * scale for q in qs]
    qpos = [p * Tq + torch.arange(Tq, device=d)
            for p, d in zip(ring.positions, devices)]
    accs = [(torch.full((B, H, Tq), _NEG_INF, device=d),
             torch.zeros((B, H, Tq), device=d),
             torch.zeros((B, H, Tq, D), device=d)) for d in devices]
    # K and V travel together: one move a step.
    kvs = [torch.stack([k, v]) for k, v in zip(ks, vs)]
    for s in range(size):
        for i, p in enumerate(ring.positions):
            owner = (p - s) % size
            accs[i] = _accumulate(accs[i], qfs[i], kvs[i][0], kvs[i][1],
                                  qpos[i], owner * Tk, causal)
        if s < size - 1:  # the last block folds in without a rotation
            kvs = _rotate(kvs, ring, devices)
    out = []
    for q, (_, l, o) in zip(qs, accs):
        o = o / torch.where(l == 0.0, 1.0, l)[..., None]
        out.append(o.transpose(1, 2).to(q.dtype))
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_axis: str = SEQ_AXIS, *, causal: bool = True,
                   scale: float | None = None) -> torch.Tensor:
    """Ring attention over global (B, T, H, D) arrays, cut on T over the
    slots of ``mesh``'s ``seq_axis`` (a ``SlotMesh``; the other axes at
    index 0 see the arrays whole). T must divide by the axis size. The
    result is joined on ``q``'s device. Where the axis spans processes,
    each computes its own slots' blocks and the others' come over the
    process group, outside autograd: each process's loss then reaches
    only its own blocks, and the ring's backward gives every K/V block
    the gradient of all of them."""
    at = mesh.coords(mesh.local_slots()[0])
    slots = mesh.axis_slots(seq_axis, {a: c for a, c in at.items()
                                       if a != seq_axis})
    ring = Ring.over(mesh, slots)
    size, T = len(slots), q.shape[1]
    if T % size:
        raise ValueError(f"sequence length {T} not divisible by the "
                         f"{seq_axis!r} axis size {size}")
    devices = [mesh.device_of(slots[p]) for p in ring.positions]

    def cut(x):
        blocks = x.chunk(size, dim=1)
        return [blocks[p].to(d) for p, d in zip(ring.positions, devices)]

    out = ring_self_attention(cut(q), cut(k), cut(v), causal=causal,
                              scale=scale, ring=ring)
    out = [o.to(q.device) for o in out]
    if len(out) < size:
        out = _join_remote(out, ring)
    return torch.cat(out, dim=1)


def _join_remote(local: list, ring: Ring) -> list:
    """Every position's block: this process's own (in autograd), the rest
    gathered from the processes holding them."""
    import torch.distributed as dist

    stack = torch.stack([o.detach() for o in local])
    parts = [torch.empty_like(stack) for _ in range(world_size())]
    dist.all_gather(parts, stack)
    mine = host_index()
    seen = {r: 0 for r in range(world_size())}
    out = []
    for p, r in enumerate(ring.ranks):
        if r == mine:
            out.append(local[ring.positions.index(p)])
        else:
            out.append(parts[r][seen[r]])
        seen[r] += 1
    return out
