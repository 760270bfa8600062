"""The port's ``DcnServer`` link shaping and ``DcnServerStats``, held to
the JAX package's.

- link classes: a table of slice maps, server hosts, client hosts and
  knobs, through ``_conn_link`` and ``_link_shaping`` of both packages'
  servers;
- the shaped wire: a shaped server's serving time is at least the bytes
  over ``rate_bps`` (less the bucket's burst), and a tagged
  ``request_many`` window pays ``window_rtt_s`` once while untagged
  requests pay it each; with a pod map, a cross-pod client is paced by
  ``wan_bps`` and pays ``wan_rtt_s`` alike, while a same-slice client's
  identical request is not;
- the stats: the same requests into a port and a reference server give
  equal stats, ``not_found`` included;
- ``/v1/status``'s ``dcn`` block has the reference's keys.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request

import numpy as np
import pytest

from zest_tpu.config import Config as JConfig
from zest_tpu.transfer import dcn as j_dcn
from zest_tpu_torch import telemetry
from zest_tpu_torch.api.http_api import PublisherServer
from zest_tpu_torch.cas import hashing
from zest_tpu_torch.cas.xorb import XorbBuilder
from zest_tpu_torch.config import Config
from zest_tpu_torch.storage import XorbCache
from zest_tpu_torch.transfer import dcn

CHUNK = 32 * 1024
N_CHUNKS = 8


def _server_pair(tmp_path, **kw):
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 dcn_port=0)
    jcfg = JConfig(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                   dcn_port=0)
    return dcn.DcnServer(cfg, **kw), j_dcn.DcnServer(jcfg, **kw)


SLICES = (0, 0, 1, 1)
PODS = (0, 0, 1, 1)
WAN = dict(wan_bps=500, wan_rtt_s=0.05)
DCN = dict(rate_bps=1000, window_rtt_s=0.01)


# (server knobs, server host, client host): both link classes, the
# anonymous client, hosts out of range, shaping off.
LINK_CASES = [
    (dict(), 0, 2),
    (dict(shape_slices=SLICES), 0, 2),
    (dict(rate_bps=1000), 0, None),
    (dict(rate_bps=1000), 0, 1),
    (dict(rate_bps=1000), 2, 0),
    (dict(window_rtt_s=0.01), None, 3),
    (dict(window_rtt_s=0.01), 0, None),
    (dict(rate_bps=1000, shape_slices=SLICES), 0, 1),
    (dict(rate_bps=1000, shape_slices=SLICES), 0, 2),
    (dict(rate_bps=1000, shape_slices=SLICES), 1, None),
    (dict(rate_bps=1000, shape_slices=SLICES), 0, 7),
    (dict(rate_bps=1000, shape_slices=SLICES), 0, -1),
    (dict(rate_bps=1000, shape_slices=SLICES), 5, 0),
    (dict(window_rtt_s=0.01, shape_slices=SLICES), 3, 2),
    (dict(rate_bps=1000, window_rtt_s=0.01, shape_slices=SLICES), 3, 0),
    (dict(rate_bps=1000, shape_slices=(0, 1, 2, 3)), 1, 2),
    (dict(rate_bps=1000, shape_slices=(0, 0, 0, 0)), 3, 0),
    (dict(rate_bps=1000, window_rtt_s=0.01, shape_slices=SLICES), 2, 3),
    # The WAN class: a pod map with WAN knobs, across pods and within.
    (dict(**DCN, **WAN, shape_slices=SLICES, shape_pods=PODS), 0, 2),
    (dict(**DCN, **WAN, shape_slices=SLICES, shape_pods=PODS), 3, 1),
    (dict(**DCN, **WAN, shape_slices=SLICES, shape_pods=PODS), 0, 1),
    # A pod map with only the DCN knobs: WAN falls back to them.
    (dict(**DCN, shape_slices=SLICES, shape_pods=PODS), 0, 3),
    (dict(window_rtt_s=0.01, shape_slices=SLICES, shape_pods=PODS), 2, 0),
    # WAN knobs and no slice map: every connection is the worst class.
    (dict(**WAN, shape_pods=PODS), 0, 1),
    (dict(**WAN), 0, 1),
    (dict(**DCN, **WAN, shape_pods=PODS), None, 2),
    # An anonymous client with a pod map is cross-pod.
    (dict(**DCN, **WAN, shape_slices=SLICES, shape_pods=PODS), 1, None),
    # A pod map shorter than the slice map: no pod test past its end.
    (dict(**DCN, **WAN, shape_slices=(0, 1, 2, 3), shape_pods=(0, 1)),
     0, 3),
    (dict(**DCN, **WAN, shape_slices=(0, 1, 2, 3), shape_pods=(0, 1)),
     0, 1),
    # A host outside the pod map, or outside the slice map.
    (dict(**DCN, **WAN, shape_slices=(0, 0, 1, 1, 2), shape_pods=PODS),
     4, 0),
    (dict(**DCN, **WAN, shape_slices=SLICES, shape_pods=PODS), 0, 6),
    # Same pod, different slice.
    (dict(**DCN, **WAN, shape_slices=(0, 1, 2, 3), shape_pods=PODS), 0, 1),
    (dict(**DCN, **WAN, shape_slices=(0, 1, 2, 3), shape_pods=PODS), 2, 3),
    # wan_bps alone: shaping is on only through the WAN bucket.
    (dict(wan_bps=500, shape_slices=SLICES, shape_pods=PODS), 0, 2),
    (dict(wan_bps=500, shape_slices=SLICES, shape_pods=PODS), 0, 1),
    (dict(wan_bps=500, shape_slices=(0, 1, 2, 3), shape_pods=PODS), 0, 1),
    (dict(wan_rtt_s=0.05, shape_slices=SLICES, shape_pods=PODS), 1, 3),
]


def _bucket_rate(bucket):
    return None if bucket is None else bucket.rate


@pytest.mark.parametrize("knobs,host,client", LINK_CASES)
def test_link_class_and_shaping_equal_reference(tmp_path, knobs, host,
                                                client):
    port, ref = _server_pair(tmp_path, shape_host=host, **knobs)
    hello = dcn.HelloInfo(subversion=2, peer_host=client)
    jhello = j_dcn.HelloInfo(subversion=2, peer_host=client)
    link = port._conn_link(hello)
    assert link == ref._conn_link(jhello)
    rtt, bucket = port._link_shaping(link)
    jrtt, jbucket = ref._link_shaping(link)
    assert rtt == jrtt
    assert _bucket_rate(bucket) == _bucket_rate(jbucket)
    # A shaped link takes one of the server's two buckets.
    assert (bucket is port._bucket) == (jbucket is ref._bucket)
    assert (bucket is port._wan_bucket) == (jbucket is ref._wan_bucket)
    assert _bucket_rate(port._wan_bucket) == _bucket_rate(ref._wan_bucket)


@pytest.fixture
def served(tmp_path):
    """One xorb of N_CHUNKS random chunks in a cache both servers read."""
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest",
                 dcn_port=0)
    rng = np.random.default_rng(7)
    builder = XorbBuilder()
    for _ in range(N_CHUNKS):
        builder.add_chunk(rng.integers(0, 256, CHUNK,
                                       dtype=np.uint8).tobytes())
    xh = builder.xorb_hash()
    XorbCache(cfg).put(hashing.hash_to_hex(xh), builder.serialize_full())
    return tmp_path, xh


def _start(server):
    return server, server.start()


def test_shaped_serving_time_at_least_bytes_over_rate(served):
    root, xh = served
    rate = 400_000
    server, port = _start(dcn.DcnServer(
        Config(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0),
        rate_bps=rate))
    ch = dcn.DcnChannel("127.0.0.1", port)
    try:
        wants = [(xh, i, i + 1) for i in range(N_CHUNKS)]
        t0 = time.monotonic()
        replies = ch.request_many(wants)
        wall = time.monotonic() - t0
    finally:
        ch.close()
        server.shutdown()
    served_bytes = sum(len(r.data) for r in replies)
    assert all(isinstance(r, dcn.DcnResponse) for r in replies)
    assert server.stats.bytes_served == served_bytes
    # The bucket starts full (its burst); everything past it is paced.
    burst = server._bucket.capacity
    assert wall >= (served_bytes - burst) / rate
    assert served_bytes - burst > 0.1 * rate  # the pacing is visible


def test_window_rtt_once_per_tagged_window(served):
    root, xh = served
    rtt = 0.1
    server, port = _start(dcn.DcnServer(
        Config(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0),
        window_rtt_s=rtt))
    ch = dcn.DcnChannel("127.0.0.1", port)

    def timed(wants, tag=0):
        t0 = time.monotonic()
        ch.request_many(wants, tag=tag)
        return time.monotonic() - t0

    try:
        wants = [(xh, i, i + 1) for i in range(N_CHUNKS)]
        tagged = timed(wants, tag=7)        # opens window 7: one RTT
        same = timed(wants[:2], tag=7)      # still window 7: none
        new_tag = timed(wants[:2], tag=8)   # window 8: one
        untagged = timed(wants)             # one a request
    finally:
        ch.close()
        server.shutdown()
    assert rtt <= tagged < 3 * rtt
    assert same < rtt
    assert rtt <= new_tag < 3 * rtt
    assert untagged >= N_CHUNKS * rtt


def _channel_as(host, port):
    """A channel whose hello names coop host ``host``."""
    with telemetry.trace.context(host=host):
        return dcn.DcnChannel("127.0.0.1", port)


def _pod_server(root, **knobs):
    return _start(dcn.DcnServer(
        Config(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0),
        shape_slices=SLICES, shape_pods=PODS, shape_host=0, **knobs))


def test_wan_client_paced_by_wan_bps_same_slice_unpaced(served):
    root, xh = served
    wan_bps = 200_000
    # The DCN knobs are generous: a WAN client's pace is wan_bps's.
    server, port = _pod_server(root, rate_bps=50_000_000, wan_bps=wan_bps)
    wants = [(xh, i, i + 1) for i in range(N_CHUNKS)]

    def timed(host):
        ch = _channel_as(host, port)
        try:
            t0 = time.monotonic()
            replies = ch.request_many(wants)
            return time.monotonic() - t0, sum(len(r.data) for r in replies)
        finally:
            ch.close()

    try:
        near, near_bytes = timed(1)   # same slice: ici, unshaped
        far, far_bytes = timed(2)     # other pod: wan
    finally:
        server.shutdown()
    assert near_bytes == far_bytes
    burst = server._wan_bucket.capacity
    assert far >= (far_bytes - burst) / wan_bps
    assert far_bytes - burst > 0.1 * wan_bps  # the pacing is visible
    # The same-slice request took no token: well under the WAN pace.
    assert near < 0.5 * (far_bytes - burst) / wan_bps
    assert server._wan_bucket.tokens < burst  # spent by the WAN client


def test_wan_rtt_once_per_tagged_window(served):
    root, xh = served
    rtt = 0.1
    # A DCN RTT far below the WAN one: a WAN window pays wan_rtt_s.
    server, port = _pod_server(root, window_rtt_s=0.001, wan_rtt_s=rtt)
    ch = _channel_as(3, port)

    def timed(wants, tag=0):
        t0 = time.monotonic()
        ch.request_many(wants, tag=tag)
        return time.monotonic() - t0

    try:
        wants = [(xh, i, i + 1) for i in range(N_CHUNKS)]
        tagged = timed(wants, tag=7)        # opens window 7: one RTT
        same = timed(wants[:2], tag=7)      # still window 7: none
        untagged = timed(wants)             # one a request
    finally:
        ch.close()
        server.shutdown()
    assert rtt <= tagged < 3 * rtt
    assert same < rtt
    assert untagged >= N_CHUNKS * rtt


def test_unshaped_server_charges_nothing(served):
    root, xh = served
    server, port = _start(dcn.DcnServer(
        Config(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0),
        shape_slices=SLICES, shape_host=0))
    try:
        ch = dcn.DcnChannel("127.0.0.1", port)
        ch.request_many([(xh, 0, N_CHUNKS)])
        ch.close()
        assert server._conn_link(None) == "ici"
        assert server._link_shaping("ici") == (0.0, None)
    finally:
        server.shutdown()


def _traffic(pool_mod, port: int, xh: bytes) -> None:
    """Two connections: hits, a miss, an invalid range, a rebased range."""
    for _ in range(2):
        ch = pool_mod.DcnChannel("127.0.0.1", port)
        try:
            ch.request_many([(xh, 0, N_CHUNKS), (xh, 2, 5),
                             (bytes(32), 0, 1), (xh, 3, 3),
                             (b"\x01" * 32, 0, 2)])
        finally:
            ch.close()


def test_stats_equal_reference_after_same_requests(served):
    root, xh = served
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0)
    jcfg = JConfig(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0)
    port_srv, port = _start(dcn.DcnServer(cfg))
    ref_srv, jport = _start(j_dcn.DcnServer(jcfg))
    try:
        _traffic(dcn, port, xh)
        _traffic(j_dcn, jport, xh)
        # A connection counts when accepted: wait for both listeners.
        deadline = time.monotonic() + 5
        while (port_srv.stats.connections < 2
               or ref_srv.stats.connections < 2) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        port_srv.shutdown()
        ref_srv.shutdown()
    got = dataclasses.asdict(port_srv.stats)
    assert got == dataclasses.asdict(ref_srv.stats)
    assert got["not_found"] == 4 and got["chunks_served"] == 4
    assert got["connections"] == 2 and got["bytes_served"] > 0
    assert list(got) == ["connections", "chunks_served", "bytes_served",
                         "not_found"]


def test_status_dcn_block_has_reference_keys(served):
    root, xh = served
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest", dcn_port=0)
    srv, port = _start(dcn.DcnServer(cfg))
    try:
        _traffic(dcn, port, xh)
        with PublisherServer(cfg, device="cpu", dcn_server=srv) as pub:
            with urllib.request.urlopen(pub.url + "/v1/status",
                                        timeout=10) as r:
                status = json.loads(r.read())
        block = status["dcn"]
    finally:
        srv.shutdown()
    # The keys the JAX package's HttpApi.status_payload writes.
    assert list(block) == ["port", "connections", "chunks_served",
                           "bytes_served", "not_found"]
    assert block["port"] == port
    assert block["chunks_served"] == 4 and block["not_found"] == 4
    assert block["bytes_served"] == srv.stats.bytes_served


def test_status_without_dcn_server_has_no_block(tmp_path):
    cfg = Config(hf_home=tmp_path / "hf", cache_dir=tmp_path / "zest")
    with PublisherServer(cfg, device="cpu") as pub:
        with urllib.request.urlopen(pub.url + "/v1/status", timeout=10) as r:
            assert "dcn" not in json.loads(r.read())
