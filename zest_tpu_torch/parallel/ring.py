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
one process holds every slot's block in a list (slot order along the
axis) and runs the ring's steps slot by slot: :func:`ring_self_attention`
takes those lists, :func:`ring_attention` cuts global (B, T, H, D) arrays
over a mesh axis and joins the result. On a ``{data, seq, model}`` grid
(Llama's TP×CP) each ``(data, model)`` row of seq slots runs its own ring
over that ``model`` slot's local heads, under the same shapes contract.

Masking is the reference's exactly: causality by global positions (block
index × block length + offset), whole future blocks at -inf; a row that
has seen only masked keys keeps its running max at -inf and subtracts 0
instead (``safe_m``), its rescale factor ``alpha`` is 0, so every exp and
its derivative stay finite.
"""

from __future__ import annotations

import math

import torch

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


def ring_self_attention(qs: list, ks: list, vs: list, *, causal: bool = True,
                        scale: float | None = None) -> list:
    """Exact (optionally causal) attention over a ring of sequence blocks.

    ``qs``, ``ks``, ``vs``: one block a slot, in slot order along the
    sequence axis, each on its slot's device: ``q`` (B, Tq, H, D), ``k``
    and ``v`` (B, Tk, Hkv, D); GQA needs H a multiple of Hkv. Returns the
    (B, Tq, H, D) output blocks in ``q``'s dtype, each on its slot's
    device. Scores and the softmax are float32."""
    ring = len(qs)
    B, Tq, H, D = qs[0].shape
    Tk, Hkv = ks[0].shape[1], ks[0].shape[2]
    if H % Hkv:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    devices = [q.device for q in qs]
    qfs = [q.float() * scale for q in qs]
    qpos = [idx * Tq + torch.arange(Tq, device=d)
            for idx, d in enumerate(devices)]
    accs = [(torch.full((B, H, Tq), _NEG_INF, device=d),
             torch.zeros((B, H, Tq), device=d),
             torch.zeros((B, H, Tq, D), device=d)) for d in devices]
    kb, vb = list(ks), list(vs)
    for s in range(ring):
        for idx in range(ring):
            owner = (idx - s) % ring
            accs[idx] = _accumulate(accs[idx], qfs[idx], kb[idx], vb[idx],
                                    qpos[idx], owner * Tk, causal)
        if s < ring - 1:  # the last block folds in without a rotation
            kb = [kb[j - 1].to(devices[j]) for j in range(ring)]
            vb = [vb[j - 1].to(devices[j]) for j in range(ring)]
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
    result is joined on ``q``'s device."""
    devices = mesh.axis_devices(seq_axis)
    ring, T = len(devices), q.shape[1]
    if T % ring:
        raise ValueError(f"sequence length {T} not divisible by the "
                         f"{seq_axis!r} axis size {ring}")

    def cut(x):
        return [blk.to(d) for blk, d in zip(x.chunk(ring, dim=1), devices)]

    out = ring_self_attention(cut(q), cut(k), cut(v), causal=causal,
                              scale=scale)
    return torch.cat([o.to(q.device) for o in out], dim=1)
