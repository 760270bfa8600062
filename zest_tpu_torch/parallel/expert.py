"""Expert-sharded distribution: route each expert's xorbs to its slot.

The counterpart of ``zest_tpu/parallel/expert.py``. Under expert
parallelism each slot holds only ``n_experts / slots`` experts, so the
plain pod round's gather of every checkpoint byte to every slot wastes
``(X-1)/X`` of the expert weights' traffic and memory. The planner splits
a pull into:

- **shared units**: xorb ranges feeding dense tensors (attention, norms,
  router, embeddings) every slot needs, distributed by the normal
  rendezvous plan and gather (``parallel/collectives.py``);
- **expert units**: ranges feeding only expert tensors, fetched by the
  slot that owns the (first) expert they feed and never gathered. A range
  touching several experts' tensors goes to the first one's slot; the
  others read it through the peer waterfall.

Coordinate chain: safetensors header → tensor byte ranges → term spans
(prefix sums of ``unpacked_length``) → fetch-info units → owner slot.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.reconstruction import Reconstruction, Term
from zest_tpu_torch.parallel.plan import (
    DistributionPlan,
    FetchAssignment,
    owner_host,
)


@dataclass(frozen=True)
class ExpertPlacement:
    """Static expert → host map, matching ``P(EXPERT_AXIS)`` sharding.

    Contiguous blocks: expert e lives on host (slot) ``e * num_hosts //
    n_experts``, the block a stacked [X, ...] tensor sharded over an
    ``expert`` mesh axis of size ``num_hosts`` gives each slot
    (``parallel/sharding.py``), so bytes routed here land on the slot
    whose shard consumes them.
    """

    n_experts: int
    num_hosts: int

    def __post_init__(self):
        if self.n_experts <= 0 or self.num_hosts <= 0:
            raise ValueError("n_experts and num_hosts must be positive")

    def host_of_expert(self, expert: int) -> int:
        if not 0 <= expert < self.n_experts:
            raise ValueError(f"expert {expert} out of range")
        return expert * self.num_hosts // self.n_experts

    def experts_of_host(self, host: int) -> list[int]:
        return [x for x in range(self.n_experts)
                if self.host_of_expert(x) == host]


@dataclass(frozen=True)
class FileTensorMap:
    """One file's routing inputs: its reconstruction + tensor byte ranges.

    ``tensor_experts`` maps absolute file byte ranges to the expert index
    owning those bytes (None = dense/shared) — built by ``classify_file``
    from a safetensors header and an ``expert_of(name)`` function such as
    models/moe.expert_of_tensor.
    """

    rec: Reconstruction
    # sorted, non-overlapping: (file_start, file_end, expert | None)
    tensor_experts: tuple[tuple[int, int, int | None], ...]


def classify_file(
    rec: Reconstruction,
    header,
    expert_of,
) -> FileTensorMap:
    """Build a FileTensorMap from a parsed safetensors header.

    Bytes not covered by any tensor (the header itself, padding) are
    shared — every host parses headers during reassembly.
    """
    spans = sorted(
        (*info.file_range(header.data_start), expert_of(name))
        for name, info in header.tensors.items()
        if info.nbytes
    )
    return FileTensorMap(rec, tuple(spans))


def _term_spans(rec: Reconstruction) -> list[tuple[int, int, Term]]:
    """Absolute file byte span of each term (prefix sums)."""
    spans, off = [], 0
    for t in rec.terms:
        spans.append((off, off + t.unpacked_length, t))
        off += t.unpacked_length
    return spans


def _experts_touching(
    span: tuple[int, int],
    tensor_experts: tuple[tuple[int, int, int | None], ...],
    starts: list[int],
) -> tuple[set[int], bool]:
    """(expert indices, any_shared_bytes) for a file byte span.

    ``shared`` is True when the span holds any byte outside expert
    tensors — dense-tensor bytes, the header, or inter-tensor padding —
    because every host needs those bytes to reassemble the file.
    """
    lo, hi = span
    experts: set[int] = set()
    shared = False
    covered = lo
    i = max(bisect_right(starts, lo) - 1, 0)
    while i < len(tensor_experts) and tensor_experts[i][0] < hi:
        t_lo, t_hi, expert = tensor_experts[i]
        if t_hi > lo:
            if expert is None:
                shared = True
            else:
                experts.add(expert)
            if t_lo > covered:
                shared = True  # uncovered gap before this tensor
            covered = max(covered, t_hi)
        i += 1
    if covered < hi:
        shared = True
    return experts, shared


@dataclass
class ExpertRoutedPlan:
    """A pull split into the all-gather plan and per-host expert fetches."""

    placement: ExpertPlacement
    shared: DistributionPlan
    # host -> the expert units it (and only it) fetches
    expert_units: dict[int, list[FetchAssignment]] = field(
        default_factory=dict
    )

    @staticmethod
    def build(
        files: list[FileTensorMap],
        placement: ExpertPlacement,
    ) -> "ExpertRoutedPlan":
        num_hosts = placement.num_hosts
        # unit key -> (fetch_info, expert owners seen, shared?)
        units: dict[tuple[str, int], list] = {}
        for fm in files:
            spans = _term_spans(fm.rec)
            starts = [s for s, _, _ in fm.tensor_experts]
            for t_lo, t_hi, term in spans:
                fi = fm.rec.find_fetch_info(term)
                if fi is None:
                    # A term no fetch_info covers can never be fetched;
                    # dropping it would produce a complete-looking plan
                    # that fails only at reassembly time.
                    raise ValueError(
                        f"no fetch_info covers term {term.hash_hex}"
                        f"[{term.range.start},{term.range.end})"
                    )
                key = (term.hash_hex, fi.range.start)
                experts, shared = _experts_touching(
                    (t_lo, t_hi), fm.tensor_experts, starts
                )
                entry = units.setdefault(key, [fi, set(), False])
                if fi.range.end > entry[0].range.end:
                    entry[0] = fi
                entry[1] |= experts
                entry[2] |= shared
        shared_plan = DistributionPlan(num_hosts, [])
        expert_units: dict[int, list[FetchAssignment]] = {}
        for (hh, start), (fi, experts, shared) in sorted(units.items()):
            if shared or not experts:
                shared_plan.assignments.append(FetchAssignment(
                    hash_hex=hh, fetch_info=fi,
                    owner=owner_host(
                        hashing.hex_to_hash(hh), start, num_hosts
                    ),
                ))
            else:
                # Unit feeds only expert tensors. Route to the host owning
                # the (deterministically) first expert; a straddling unit's
                # other experts read it via the peer waterfall.
                host = placement.host_of_expert(min(experts))
                expert_units.setdefault(host, []).append(FetchAssignment(
                    hash_hex=hh, fetch_info=fi, owner=host,
                ))
        return ExpertRoutedPlan(placement, shared_plan, expert_units)

    def units_for_host(self, host: int) -> list[FetchAssignment]:
        """Everything this host fetches from CDN/disk: its rendezvous share
        of the shared plan plus its experts' private units."""
        return self.shared.for_host(host) + self.expert_units.get(host, [])

    @property
    def expert_bytes(self) -> int:
        return sum(
            a.est_bytes for units in self.expert_units.values()
            for a in units
        )

    def summary(self) -> dict:
        shared = self.shared.summary()
        per_host = [0] * self.placement.num_hosts
        for host, units in self.expert_units.items():
            per_host[host] += sum(a.est_bytes for a in units)
        total = self.expert_bytes
        n = self.placement.num_hosts
        return {
            "shared": shared,
            "expert_units": sum(len(u) for u in self.expert_units.values()),
            "expert_bytes": total,
            "expert_bytes_per_host": per_host,
            # Gather bytes the split avoids (the JAX package's name: its
            # gather rides ICI): a gather would move each expert byte to
            # the other n-1 slots.
            "ici_bytes_saved": total * (n - 1),
        }
