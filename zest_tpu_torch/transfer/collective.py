"""The collective-native coop exchange: a plan-derived all-to-all in
synchronized phases.

The counterpart of ``zest_tpu/transfer/collective.py``. The point-to-point
exchange (``transfer/coop.py``) pulls every foreign unit from its owner in
per-owner windows with a per-unit NOT_FOUND retry loop. The collective
derives the whole N×N send/recv byte matrix from the shared
:class:`~zest_tpu_torch.transfer.coop.CoopPlan` (fingerprint-identical on
every host, so there is no negotiation) and redistributes in phases: a
recursive-doubling **hypercube** when the alive-host count is a power of
two (log2 N phases), a **ring** otherwise (N-1 phases, one constant
neighbour), a **hierarchical** schedule over equal power-of-two slices
(cross-slice counterparts first, then an intra-slice spread) and, with a
pod map, the **federated** three-level schedule. Each phase sends one
pre-sized window (paged under the round's byte budget) to one partner.

- **Compressed through the collective**: windows move xorb frame streams,
  BG4 and LZ4 payloads still compressed, and the receiver verifies every
  provably whole xorb on its device (``transfer/pod.make_unit_verifier``:
  the fused BG4 kernel, the BLAKE3 kernel for the rest) before it is
  cached. A verifier that fails to build or launch raises out of
  :func:`run_collective`.
- **Topology**: hosts rank slice-major (``Config.coop_topology``, else
  :func:`transfer.pod.local_slice_groups`, else one flat slice), so early
  phases ride intra-slice (``ici``) links and the few late ones cross
  slices (``dcn``); pods add ``wan``. Phase bytes count per link class
  (``zest_coop_collective_bytes_total{link}``).
- **Transports**: phases run against ``transfer/transport.py``'s
  protocol: the DCN wire (default), the device lane, or the loopback
  fabric.
- **Degradation, never a stall**: NOT_FOUND means the partner is behind
  (a request names only units the partner is scheduled to hold by then),
  so the missing set is re-requested as one window after a backoff,
  blamed to ``coop.collective.barrier`` spans; a dead partner, a deadline
  or a remediation abort ends the collective, and every undelivered unit
  returns to its true owner for the point-to-point exchange, which
  degrades per unit to the CDN.

The JAX package's lossy tier (``ZEST_COLLECTIVE_LOSSY``) is not ported:
the configuration refuses it, and every window is byte-exact.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from zest_tpu_torch import faults, telemetry
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.config import DEFAULT_DEVICE, parse_topology
from zest_tpu_torch.transfer.dcn import DcnResponse
from zest_tpu_torch.transfer.transport import (
    TransportUnavailable,
    make_transport,
)

_M_PHASE_SECONDS = telemetry.histogram(
    "zest_coop_collective_phase_seconds",
    "Wall seconds per collective exchange phase",
    buckets=(0.005, 0.02, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0))
_M_COLLECTIVE_BYTES = telemetry.counter(
    "zest_coop_collective_bytes_total",
    "Collective exchange wire bytes by link class", ("link",))
_M_COLLECTIVE_PHASES = telemetry.gauge(
    "zest_coop_collective_phases",
    "Phase count of this host's last collective exchange")
_M_COLLECTIVE_WALL = telemetry.gauge(
    "zest_coop_collective_wall_seconds",
    "This host's last collective exchange wall time")
_M_COLLECTIVE_ABORTS = telemetry.counter(
    "zest_coop_collective_aborts_total",
    "Collective exchanges aborted to the point-to-point ladder")

# A phase's window is paged into sub-windows of at most this much (and
# never past the round's byte budget): one partner at a predictable rate.
_PHASE_WINDOW_BYTES = 64 * 1024 * 1024
_PHASE_WINDOW_UNITS = 512
# Barrier pacing: a NOT_FOUND window means the partner has not reached
# this phase yet; back off, then re-request the whole missing set.
_BARRIER_SLEEP_S = 0.05
_BARRIER_SLEEP_CAP_S = 1.0

LINK_ICI = "ici"
LINK_DCN = "dcn"
LINK_WAN = "wan"


class CollectiveUnavailable(RuntimeError):
    """The collective cannot run this round (a partner without an
    address, nobody to exchange with, an unknown backend): the caller
    takes the point-to-point exchange."""


def slice_topology(n_hosts: int, cfg=None,
                   env: dict | None = None) -> tuple[int, ...]:
    """Slice id per host index: an explicit ``env`` dict's
    ``ZEST_COOP_TOPOLOGY`` (the process environment is parsed once, by
    ``Config.load``), then ``cfg.coop_topology``, then the runtime's
    (:func:`transfer.pod.local_slice_groups`), then one flat slice. A map
    whose length disagrees with the round raises ``ValueError``."""
    spec = (env or {}).get("ZEST_COOP_TOPOLOGY")
    topo = parse_topology(spec) if spec else (
        cfg.coop_topology if cfg is not None else None)
    if topo is not None:
        if len(topo) != n_hosts:
            raise ValueError(f"ZEST_COOP_TOPOLOGY names {len(topo)} hosts "
                             f"for an {n_hosts}-host round")
        return tuple(topo)
    from zest_tpu_torch.transfer.pod import local_slice_groups

    topo = local_slice_groups(n_hosts)
    return topo if topo is not None else (0,) * n_hosts


def pod_topology(n_hosts: int, cfg=None,
                 env: dict | None = None) -> tuple[int, ...] | None:
    """Pod id per host index, or None (one pod): an explicit ``env``
    dict's ``ZEST_COOP_PODS``, then ``cfg.coop_pods``. A map whose length
    disagrees with the round raises ``ValueError``."""
    spec = (env or {}).get("ZEST_COOP_PODS")
    pods = parse_topology(spec) if spec else (
        cfg.coop_pods if cfg is not None else None)
    if pods is None:
        return None
    if len(pods) != n_hosts:
        raise ValueError(f"ZEST_COOP_PODS names {len(pods)} hosts for an "
                         f"{n_hosts}-host round")
    return tuple(pods)


def elect_gateways(plan, pods: tuple[int, ...]) -> dict[int, int]:
    """Pod id → its lowest alive host index: every host elects the same
    gateways from the same plan, and a quarantined gateway's role passes
    to the next-lowest member."""
    out: dict[int, int] = {}
    for h in sorted(plan.alive):
        out.setdefault(pods[h], h)
    return dict(sorted(out.items()))


@dataclass(frozen=True)
class Phase:
    """One step of a host's schedule: request from ``partner`` every
    plan unit owned by the hosts in ``owners`` (what the partner is
    scheduled to hold by then)."""

    index: int
    partner: int                 # host index (not rank)
    owners: tuple[int, ...]      # host indices whose units to request
    link: str                    # "ici" | "dcn" | "wan"


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _doubling(members, r: int, start: int, link_to) -> list[Phase]:
    """Recursive-doubling phases of rank ``r`` among ``members``
    (a power-of-two count): at step k, pull the partner's 2^k-owner
    subcube."""
    phases = []
    for k in range(len(members).bit_length() - 1):
        p = r ^ (1 << k)
        phases.append(Phase(start + k, members[p],
                            tuple(members[p ^ q] for q in range(1 << k)),
                            link_to(members[p])))
    return phases


def _ring(members, r: int, start: int, link_to) -> list[Phase]:
    """Ring phases of rank ``r``: N-1 pulls from the constant left
    neighbour, one owner block each."""
    left = members[(r - 1) % len(members)]
    return [Phase(start + k, left, (members[(r - 1 - k) % len(members)],),
                  link_to(left)) for k in range(len(members) - 1)]


@dataclass(frozen=True)
class CollectiveSchedule:
    """A host's deterministic phase schedule over ``plan.alive``: every
    host computes every other host's schedule from the same plan and
    topology, which is what lets a window name exactly the units its
    partner holds.

    - **hierarchical** (≥ 2 equal power-of-two slices of power-of-two
      size ≥ 2): a cross-slice all-gather of the counterparts' own blocks
      (one copy of each slice's data crosses), then an intra-slice one of
      whole counterpart groups;
    - **hypercube** (power-of-two hosts): recursive doubling, ranks
      slice-major so low-bit partners are intra-slice;
    - **ring** (otherwise): N-1 phases from the left neighbour;
    - **federated** (a pod map naming ≥ 2 alive pods): an intra-pod
      all-gather of the pod's own blocks, then the gateways (lowest alive
      host of each pod) all-gather the pod aggregates over WAN, then an
      intra-pod binomial broadcast of the foreign blocks."""

    kind: str   # "hierarchical" | "hypercube" | "ring" | "federated"
    host: int
    alive: tuple[int, ...]       # rank order (pod- then slice-major)
    phases: tuple[Phase, ...]

    @staticmethod
    def build(plan, host_index: int, topology: tuple[int, ...],
              pods: tuple[int, ...] | None = None) -> "CollectiveSchedule":
        if host_index not in plan.alive:
            raise CollectiveUnavailable(
                f"host {host_index} is not in the plan's alive set")
        if max(plan.alive) >= len(topology):
            raise ValueError(f"topology names {len(topology)} hosts but "
                             f"the plan includes host {max(plan.alive)}")
        if pods is not None and max(plan.alive) >= len(pods):
            raise ValueError(f"pod map names {len(pods)} hosts but the "
                             f"plan includes host {max(plan.alive)}")

        def link_to(b: int) -> str:
            if pods is not None and pods[host_index] != pods[b]:
                return LINK_WAN
            return LINK_ICI if topology[host_index] == topology[b] \
                else LINK_DCN

        if pods is not None and len({pods[h] for h in plan.alive}) >= 2:
            return CollectiveSchedule._build_federated(
                plan, host_index, topology, pods, link_to)

        order = tuple(sorted(plan.alive, key=lambda h: (topology[h], h)))
        n = len(order)
        if n < 2:
            raise CollectiveUnavailable("nothing to exchange with")
        slices: list[list[int]] = []
        for h in order:  # slice-major, so each slice is contiguous
            if slices and topology[slices[-1][0]] == topology[h]:
                slices[-1].append(h)
            else:
                slices.append([h])
        m = len(slices[0])
        hier = (len(slices) >= 2 and m >= 2 and _is_pow2(len(slices))
                and _is_pow2(m) and all(len(sl) == m for sl in slices))
        if hier:
            gidx, pos = next((gi, sl.index(host_index))
                             for gi, sl in enumerate(slices)
                             if host_index in sl)
            phases = _doubling([sl[pos] for sl in slices], gidx, 0, link_to)
            members = slices[gidx]
            for k in range(m.bit_length() - 1):
                pp = pos ^ (1 << k)
                phases.append(Phase(len(phases), members[pp], tuple(
                    sl[pp ^ q] for q in range(1 << k) for sl in slices),
                    link_to(members[pp])))
            kind = "hierarchical"
        elif _is_pow2(n):
            phases, kind = _doubling(order, order.index(host_index), 0,
                                     link_to), "hypercube"
        else:
            phases, kind = _ring(order, order.index(host_index), 0,
                                 link_to), "ring"
        return CollectiveSchedule(kind, host_index, order, tuple(phases))

    @staticmethod
    def _build_federated(plan, host_index: int, topology: tuple[int, ...],
                         pods: tuple[int, ...],
                         link_to) -> "CollectiveSchedule":
        pod_ids = sorted({pods[h] for h in plan.alive})
        members_by_pod = {
            p: sorted((h for h in plan.alive if pods[h] == p),
                      key=lambda h: (topology[h], h))
            for p in pod_ids}
        gateways = elect_gateways(plan, pods)
        my_pod = pods[host_index]
        members = members_by_pod[my_pod]
        gw = gateways[my_pod]

        # Stage A: intra-pod all-gather of the pod's own blocks.
        r = members.index(host_index)
        phases: list[Phase] = []
        if len(members) >= 2:
            phases = (_doubling if _is_pow2(len(members)) else _ring)(
                members, r, 0, link_to)
        if host_index == gw:
            # Stage B, gateways only: all-gather the pod aggregates (a
            # phase's owners are every alive host of the partner's pods).
            pr = pod_ids.index(my_pod)
            if _is_pow2(len(pod_ids)):
                for k in range(len(pod_ids).bit_length() - 1):
                    pp = pr ^ (1 << k)
                    partner = gateways[pod_ids[pp]]
                    phases.append(Phase(len(phases), partner, tuple(
                        h for q in range(1 << k)
                        for h in members_by_pod[pod_ids[pp ^ q]]),
                        link_to(partner)))
            else:
                left_gw = gateways[pod_ids[(pr - 1) % len(pod_ids)]]
                for k in range(len(pod_ids) - 1):
                    op = pod_ids[(pr - 1 - k) % len(pod_ids)]
                    phases.append(Phase(len(phases), left_gw,
                                        tuple(members_by_pod[op]),
                                        link_to(left_gw)))
        else:
            # Stage C: binomial broadcast of the foreign blocks,
            # gateway first: position p pulls from p - 2^floor(log2 p).
            foreign = tuple(h for p in pod_ids if p != my_pod
                            for h in members_by_pod[p])
            bcast = [gw] + [h for h in members if h != gw]
            bpos = bcast.index(host_index)
            src = bcast[bpos - (1 << (bpos.bit_length() - 1))]
            phases.append(Phase(len(phases), src, foreign, link_to(src)))
        order = tuple(sorted(plan.alive,
                             key=lambda h: (pods[h], topology[h], h)))
        return CollectiveSchedule("federated", host_index, order,
                                  tuple(phases))


def units_by_owner(plan) -> dict[int, list]:
    """``{owner: [(hash_hex, FetchInfo), ...]}``: the blocks phases are
    expressed in."""
    out: dict[int, list] = {h: [] for h in plan.alive}
    for key, fi in plan.units:
        out[plan.owners[key]].append((key[0], fi))
    return out


def transfer_matrix(plan, topology: tuple[int, ...],
                    pods: tuple[int, ...] | None = None) -> list[list[int]]:
    """``matrix[src][dst]``: the wire bytes host ``dst`` requests from
    ``src`` over its whole schedule, from the plan and topology alone
    (zeros for quarantined hosts)."""
    blocks = units_by_owner(plan)
    block_bytes = {h: sum(fi.url_range_end - fi.url_range_start
                          for _hh, fi in us) for h, us in blocks.items()}
    matrix = [[0] * plan.n_hosts for _ in range(plan.n_hosts)]
    for dst in plan.alive:
        for ph in CollectiveSchedule.build(plan, dst, topology,
                                           pods).phases:
            matrix[ph.partner][dst] += sum(block_bytes[o]
                                           for o in ph.owners)
    return matrix


def matrix_skew(matrix: list[list[int]]) -> float:
    """Most bytes a host sends over the mean (1.0: balanced links)."""
    sent = [sum(row) for row in matrix if sum(row)]
    if not sent:
        return 1.0
    return max(sent) / (sum(sent) / len(sent))


def run_collective(bridge, plan, host_index: int,
                   peers: dict[int, tuple[str, int]], pool, budget, ex,
                   verify, deadline: float, topology: tuple[int, ...],
                   priorities: dict | None = None,
                   entries_map: dict | None = None, health=None,
                   pods: tuple[int, ...] | None = None, transport=None,
                   device=DEFAULT_DEVICE) -> tuple[dict, dict[int, list]]:
    """Run this host's phase schedule. Returns ``(stats,
    leftover_by_owner)``: empty leftovers on success; after an abort,
    true owner → the units not delivered, for the point-to-point
    exchange.

    ``transport`` overrides ``bridge.cfg.collective_backend``'s (built on
    ``pool``; the device lane runs on ``device``). Raises
    :class:`CollectiveUnavailable` before any wire traffic when a
    scheduled partner has no address or the backend is unknown."""
    from zest_tpu_torch.transfer.coop import (
        _admit,
        _already_cached,
        _fallback,
        _layer_order,
    )

    sched = CollectiveSchedule.build(plan, host_index, topology, pods)
    for ph in sched.phases:
        if ph.partner not in peers:
            raise CollectiveUnavailable(
                f"phase {ph.index} partner host {ph.partner} has no DCN "
                "address")
    if transport is None:
        try:
            transport = make_transport(bridge.cfg.collective_backend, pool,
                                       plan=plan, device=device)
        except TransportUnavailable as exc:
            raise CollectiveUnavailable(str(exc)) from exc
    blocks = units_by_owner(plan)

    t0 = time.monotonic()
    phase_walls: list[float] = []
    link_bytes = {LINK_ICI: 0, LINK_DCN: 0}
    if pods is not None:
        link_bytes[LINK_WAN] = 0  # the wan key exists only with a pod map
    windows = requests = retry_windows = 0
    barrier_s = 0.0
    window_cap = min(_PHASE_WINDOW_BYTES, budget.budget_bytes)
    stats: dict = {
        "schedule": sched.kind,
        "phases": len(sched.phases),
        "phase_wall_s": phase_walls,
        "matrix_skew": round(matrix_skew(
            transfer_matrix(plan, topology, pods)), 4),
        "link_bytes": link_bytes,
        "windows": 0,
        "requests": 0,
        "retry_windows": 0,
        # Requests outside a phase window: structurally none.
        "unit_round_trips": 0,
        "barrier_wait_s": 0.0,
    }
    if transport.name != "dcn":
        stats["backend"] = transport.name

    def finish(aborted: str | None = None,
               dead_host: int | None = None) -> dict:
        telemetry.timeline.clear("collective.")
        stats.update(windows=windows, requests=requests,
                     retry_windows=retry_windows,
                     barrier_wait_s=round(barrier_s, 3),
                     elapsed_s=round(time.monotonic() - t0, 3))
        if aborted:
            stats["aborted"] = aborted
            if dead_host is not None:
                stats["dead_host"] = dead_host
        _M_COLLECTIVE_PHASES.set(float(len(sched.phases)))
        _M_COLLECTIVE_WALL.set(time.monotonic() - t0)
        return stats

    def abort(ph, error: str, pending: list) -> tuple[dict, dict]:
        _M_COLLECTIVE_ABORTS.inc()
        telemetry.record("collective_abort", phase=ph.index,
                         partner=ph.partner, link=ph.link, error=error)
        return (finish(aborted=error, dead_host=ph.partner),
                leftovers(ph.index, pending))

    def leftovers(from_phase: int, pending: list) -> dict[int, list]:
        """Undelivered units by true owner: the current phase's rest and
        every later phase's blocks, less what is cached by now."""
        out: dict[int, list] = {}
        for hh, fi in pending:
            if not _already_cached(bridge, hh, fi):
                out.setdefault(plan.owners[(hh, fi.range.start)],
                               []).append((hh, fi))
        for ph in sched.phases[from_phase + 1:]:
            for o in ph.owners:
                for hh, fi in blocks[o]:
                    if not _already_cached(bridge, hh, fi):
                        out.setdefault(o, []).append((hh, fi))
        return out

    # The remediation target: "strike" blames a partner to peer health,
    # "abort" ends the exchange at the next barrier, down the
    # point-to-point ladder.
    abort_req: dict = {}

    def remediate_cmd(cmd: str, partner: int) -> dict:
        if cmd == "strike":
            if health is not None and partner in peers:
                health.record_failure(peers[partner], kind="straggler")
            return {"cmd": "strike", "partner": partner}
        if cmd == "abort":
            abort_req["partner"] = partner
            return {"cmd": "abort", "partner": partner}
        return {"cmd": cmd, "partner": partner, "ignored": True}

    telemetry.remediate.register_target("collective", remediate_cmd)
    try:
        for ph in sched.phases:
            host, port = peers[ph.partner]
            wants = _layer_order(
                [(hh, fi) for o in ph.owners for hh, fi in blocks[o]
                 if not _already_cached(bridge, hh, fi)], priorities)
            t_phase = time.monotonic()
            telemetry.timeline.post("collective.phase", ph.index)
            telemetry.timeline.post("collective.partner", ph.partner)
            telemetry.timeline.post("collective.barrier_s", barrier_s)
            sleep_s = _BARRIER_SLEEP_S
            # A barrier re-request (partner behind), as opposed to plain
            # paging of a phase larger than one sub-window.
            retry_pass = False
            with telemetry.span(f"coop.collective.phase{ph.index}",
                                partner=ph.partner, link=ph.link,
                                units=len(wants)):
                pending = list(wants)
                while pending:
                    window, wire_est = [], 0
                    while pending and len(window) < _PHASE_WINDOW_UNITS:
                        fi = pending[0][1]
                        nbytes = fi.url_range_end - fi.url_range_start
                        if window and wire_est + nbytes > window_cap:
                            break
                        window.append(pending.pop(0))
                        wire_est += nbytes
                    budget.acquire(wire_est)
                    try:
                        if faults.fire("peer_timeout",
                                       key=f"{host}:{port}"):
                            raise TimeoutError("injected peer_timeout")
                        replies = transport.request_window(
                            ph.partner, (host, port),
                            [(hashing.hex_to_hash(hh), fi.range.start,
                              fi.range.end) for hh, fi in window],
                            timeout=max(1.0, deadline - time.monotonic()),
                            tag=transport.window_tag(), link=ph.link)
                        windows += 1
                        requests += len(window)
                        if retry_pass:
                            retry_windows += 1
                            retry_pass = False
                    except (ConnectionError, TimeoutError, OSError) as exc:
                        budget.release(wire_est)
                        with ex.lock:
                            ex.dead_hosts.add(ph.partner)
                        if health is not None:
                            health.record_failure((host, port),
                                                  kind="io_timeout")
                        return abort(ph, type(exc).__name__,
                                     window + pending)
                    missing = []
                    try:
                        for (hh, fi), reply in zip(window, replies):
                            admitted, wire, unpacked = _admit(
                                bridge, entries_map, hh, fi, reply, verify)
                            if admitted:
                                bridge.stats.record("peer", wire)
                                ex.book_exchange((hh, fi.range.start), wire,
                                                 unpacked, link=ph.link)
                                link_bytes[ph.link] += wire
                                _M_COLLECTIVE_BYTES.inc(wire, link=ph.link)
                            elif isinstance(reply, DcnResponse):
                                # Bad bytes from a live partner: the same
                                # bytes would come back, so the unit heals
                                # through the waterfall instead.
                                with ex.lock:
                                    ex.verify_rejected += 1
                                telemetry.record(
                                    "verify_rejected", unit=hh[:16],
                                    owner=ph.partner, tier="collective")
                                _fallback(bridge, entries_map, [(hh, fi)],
                                          ex, owner=ph.partner)
                            else:
                                missing.append((hh, fi))  # partner behind
                    finally:
                        budget.release(wire_est)
                    if missing:
                        if abort_req:
                            with ex.lock:
                                ex.dead_hosts.add(ph.partner)
                            return abort(ph, "remediation",
                                         missing + pending)
                        if time.monotonic() + sleep_s > deadline:
                            return abort(ph, "deadline", missing + pending)
                        with telemetry.span("coop.collective.barrier",
                                            phase=ph.index,
                                            partner=ph.partner,
                                            units=len(missing)):
                            time.sleep(sleep_s)
                        barrier_s += sleep_s
                        telemetry.timeline.post("collective.barrier_s",
                                                barrier_s)
                        sleep_s = min(sleep_s * 2, _BARRIER_SLEEP_CAP_S)
                        retry_pass = True
                        pending = missing + pending
            wall = time.monotonic() - t_phase
            phase_walls.append(round(wall, 4))
            _M_PHASE_SECONDS.observe(wall)
            if health is not None:
                health.record_success((host, port))
        return finish(), {}
    finally:
        telemetry.remediate.unregister_target("collective", remediate_cmd)
