"""The hot-swap of a tree sharded over a slot mesh, against the JAX
package's swap over its mesh, on the CPU.

Mirrors tests/test_delta.py's end-to-end swap tests over a
``{"model": 4}`` and a ``{"data": 2, "model": 4}`` mesh: the port pulls
revision A with ``mesh=model_mesh(axes, ["cpu"] * n)``, then B with A's
sharded tree as ``base_params``; the JAX package pulls the same
revisions under ``ZEST_TPU_MESH`` (``device="tpu"`` on its 8-device
virtual mesh, the first four devices for ``{"model": 4}``). In the first
test's ``{"model": 4}`` case both swaps run the pod pre-pass over the
mesh's slots (the plain BLAKE3 on the CPU makes it the slow part, so the
other cases leave it off). The port's cold mesh pulls of B, which several
tests compare with, are made once per module. The fixture packs one chunk per xorb,
where the reference's fingerprints see every unchanged chunk, so the
reused names are the reference's.

Held equal to the reference: the reused names, ``hbm.swap``,
``stats["delta"]`` (fetched bytes included), the ``stats["pod"]`` block
(times excepted), ``params_digest`` (also the port's cold mesh pull of
B's), and every slot's shard of every tensor, byte for byte. Port-only:
a base landed under another spec or over another mesh reuses nothing and
still lands B's tree; a swap whose commit fails after its first group
gives every reused ``ShardedTensor`` back to the caller's dict.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from tests.fixtures import FixtureHub, FixtureRepo
from zest_tpu.bench_scale import llama_checkpoint_files
from zest_tpu.config import Config as JConfig, MeshConfig as JMesh
from zest_tpu.models import loader as j_loader
from zest_tpu.parallel import mesh as j_mesh
from zest_tpu.transfer import pull as j_pull
from zest_tpu_torch.config import Config
from zest_tpu_torch.models import loader
from zest_tpu_torch.parallel.mesh import model_mesh
from zest_tpu_torch.parallel.sharding import P, ShardedTensor, shard_tensor
from zest_tpu_torch.transfer import delta
from zest_tpu_torch.transfer import pull as port_pull

REPO = "acme/mesh-delta"
FILES_A = llama_checkpoint_files(0.002, seed=3, shard_bytes=1024 * 1024,
                                 scale=16)
FILES_B = llama_checkpoint_files(0.002, seed=3, shard_bytes=1024 * 1024,
                                 scale=16, mutate_fraction=0.01)
SHA_A = "f1x7ure5ha" + "0" * 30  # FixtureRepo's default commit sha
SHA_B = "b" * 40
MESHES = {"model4": {"model": 4}, "data2_model4": {"data": 2, "model": 4}}
TIMES = {"fetch_s", "gather_s", "fill_s", "elapsed_s"}


@pytest.fixture(scope="module")
def hub():
    repo = FixtureRepo(REPO, FILES_A, chunks_per_xorb=1)
    repo.add_revision(FILES_B, commit_sha=SHA_B)
    with FixtureHub(repo) as h:
        yield h


def _quiet(*a, **k):
    pass


def _n(axes) -> int:
    return int(np.prod(list(axes.values())))


@pytest.fixture(scope="module")
def cold(hub, tmp_path_factory):
    """The port's cold mesh pull of B over ``axes`` with ``cfg_kw``, made
    once per module."""
    made: dict = {}

    def pull(axes, cfg_kw=None):
        key = (tuple(axes.items()), tuple(sorted((cfg_kw or {}).items())))
        if key not in made:
            made[key] = _pull(hub, tmp_path_factory.mktemp("cold"), SHA_B,
                              axes, cfg_kw)
        return made[key]
    return pull


def _pull(hub, root, revision, axes, cfg_kw=None, pod=False, **kw):
    cfg = Config(hf_home=root / "hf", cache_dir=root / "zest",
                 hf_token="hf_test", endpoint=hub.url, **(cfg_kw or {}))
    kw.setdefault("mesh", model_mesh(axes, ["cpu"] * _n(axes)))
    return port_pull.pull_model(cfg, REPO, revision=revision, device="cpu",
                                pod=pod, no_p2p=True, log=_quiet, **kw)


@pytest.fixture
def ref_pull(monkeypatch):
    """The JAX package's pull over ``axes``: its landing mesh and its pod
    pre-pass over the first ``n`` virtual devices, as the port's slots."""
    model_mesh_of, pod_mesh_of = j_mesh.model_mesh, j_mesh.pod_mesh

    def pull(hub, root, revision, axes, cfg_kw=None, pod=False, **kw):
        devices = jax.devices()[:_n(axes)]
        monkeypatch.setattr(j_mesh, "mesh_from_config",
                            lambda m, d=None: model_mesh_of(m.mesh_axes,
                                                            devices))
        monkeypatch.setattr(j_mesh, "pod_mesh",
                            lambda d=None: pod_mesh_of(devices))
        cfg = JConfig(hf_home=root / "hf", cache_dir=root / "zest",
                      hf_token="hf_test", endpoint=hub.url,
                      mesh=JMesh(mesh_axes=axes), **(cfg_kw or {}))
        return j_pull.pull_model(cfg, REPO, revision=revision, device="tpu",
                                 pod=pod, no_p2p=True, log=_quiet, **kw)
    return pull


def _swap(pull, hub, root, axes, cfg_kw=None, pod=False):
    """Pull A, then B over A's tree (the pod pre-pass in B's pull when
    ``pod``): ``(A's tree as it was, B's result, the base dict after)``."""
    res_a = pull(hub, root, SHA_A, axes, cfg_kw)
    base = res_a.params
    before = dict(base)
    res_b = pull(hub, root, SHA_B, axes, cfg_kw, pod=pod, base_params=base,
                 base_revision=SHA_A)
    return before, res_b, base


def _reused(before: dict, res) -> set[str]:
    return {n for n, t in res.params.items() if before.get(n) is t}


def _untimed(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in TIMES}


def _assert_shards_equal(params, jparams):
    """Every slot's shard equals the reference's shard on the device of
    the same index, byte for byte."""
    assert set(params) == set(jparams)
    devices = jax.devices()
    for name, st in params.items():
        assert isinstance(st, ShardedTensor), name
        ref = {devices.index(s.device): np.asarray(s.data)
               for s in jparams[name].addressable_shards}
        assert set(ref) == set(st.shards), name
        for slot, want in ref.items():
            got = st.shard(slot).contiguous()
            assert np.array_equal(got.view(torch.uint8).numpy().reshape(-1),
                                  want.view(np.uint8).reshape(-1)), (name,
                                                                     slot)


@pytest.mark.parametrize("axes", list(MESHES.values()), ids=list(MESHES))
def test_hot_swap_digest_identical_and_changed_bytes_only(hub, tmp_path,
                                                          ref_pull, cold,
                                                          axes):
    pod = axes == MESHES["model4"]
    before, res, base = _swap(_pull, hub, tmp_path / "port", axes, pod=pod)
    j_before, ref, j_base = _swap(ref_pull, hub, tmp_path / "ref", axes,
                                  pod=pod)
    st, j_st = res.stats, ref.stats
    assert st["mesh"] == axes and st["hbm"]["sharded"] is True
    digest = loader.params_digest(res.params)
    assert digest == j_loader.params_digest(ref.params)
    assert digest == loader.params_digest(cold(axes).params)
    assert st["delta"] == j_st["delta"]
    assert st["hbm"]["swap"] == j_st["hbm"]["swap"]
    assert _untimed(st.get("pod", {})) == _untimed(j_st.get("pod", {}))
    if pod:
        assert st["pod"]["slots"] == _n(axes)
    fetched = st["fetch"]["bytes"]["cdn"]
    assert st["delta"]["fetched_bytes"] == fetched == \
        j_st["fetch"]["bytes"]["cdn"]
    # Changed bytes only (tests/test_delta.py's bound); at this fixture's
    # size the 1% of flipped bytes touches ~12% of the 64 KiB chunks.
    assert fetched <= st["delta"]["changed_bytes"] * 1.1
    assert fetched < 0.25 * sum(map(len, FILES_B.values()))
    assert st["time_to_swap_s"] == st["time_to_hbm_s"]
    reused = _reused(before, res)
    assert reused == _reused(j_before, ref)
    assert 0 < len(reused) == st["hbm"]["swap"]["reused_tensors"] \
        == st["delta"]["tensors"]["reused"]
    assert not base and not j_base, "the base dict is consumed"
    _assert_shards_equal(res.params, ref.params)
    for name, data in FILES_B.items():
        assert (res.snapshot_dir / name).read_bytes() == data, name


@pytest.mark.parametrize("axes", list(MESHES.values()), ids=list(MESHES))
def test_non_streamed_hot_swap_identical(hub, tmp_path, ref_pull, axes):
    kw = {"land_stream": False}
    before, res, base = _swap(_pull, hub, tmp_path / "port", axes, kw)
    j_before, ref, _ = _swap(ref_pull, hub, tmp_path / "ref", axes, kw)
    assert res.stats["hbm"]["swap"] == ref.stats["hbm"]["swap"]
    assert res.stats["hbm"]["swap"]["reused_tensors"] > 0
    assert _reused(before, res) == _reused(j_before, ref)
    assert not base
    assert res.stats["time_to_swap_s"] is not None
    assert loader.params_digest(res.params) == j_loader.params_digest(
        ref.params)
    _assert_shards_equal(res.params, ref.params)


@pytest.mark.parametrize("axes", list(MESHES.values()), ids=list(MESHES))
def test_dtype_mismatch_reuses_nothing_but_stays_correct(hub, tmp_path,
                                                         ref_pull, cold,
                                                         axes):
    kw = {"land_dtype": "f32"}
    res_a = _pull(hub, tmp_path / "d", SHA_A, axes)  # the checkpoint's bf16
    base = res_a.params
    res = _pull(hub, tmp_path / "d", SHA_B, axes, kw, base_params=base,
                base_revision=SHA_A)
    ref_a = ref_pull(hub, tmp_path / "r", SHA_A, axes)
    ref = ref_pull(hub, tmp_path / "r", SHA_B, axes, kw,
                   base_params=ref_a.params, base_revision=SHA_A)
    assert res.stats["hbm"]["swap"] == ref.stats["hbm"]["swap"]
    assert res.stats["hbm"]["swap"]["reused_tensors"] == 0
    assert not base
    assert loader.params_digest(res.params) == loader.params_digest(
        cold(axes, kw).params) == j_loader.params_digest(ref.params)
    _assert_shards_equal(res.params, ref.params)


@pytest.mark.parametrize("axes", list(MESHES.values()), ids=list(MESHES))
def test_fresh_mesh_delta_identical(hub, tmp_path, ref_pull, axes):
    """No resident base tree: the delta still plans (the network moves
    only changed bytes) but every tensor lands fresh, with no swap keys."""
    _pull(hub, tmp_path / "d", SHA_A, axes)
    res = _pull(hub, tmp_path / "d", SHA_B, axes)
    ref_pull(hub, tmp_path / "r", SHA_A, axes)
    ref = ref_pull(hub, tmp_path / "r", SHA_B, axes)
    assert res.stats["fetch"]["bytes"]["cdn"] <= \
        res.stats["delta"]["changed_bytes"] * 1.1
    assert res.stats["delta"] == ref.stats["delta"]
    assert "tensors" not in res.stats["delta"]
    assert "time_to_swap_s" not in res.stats
    assert "swap" not in res.stats["hbm"]
    assert loader.params_digest(res.params) == j_loader.params_digest(
        ref.params)
    _assert_shards_equal(res.params, ref.params)


def _replicated(tree: dict) -> dict:
    mesh = next(iter(tree.values())).mesh
    return {n: shard_tensor(t.full(), mesh, P()) for n, t in tree.items()}


@pytest.mark.parametrize("base_layout", ["another_spec", "another_mesh",
                                         "unsharded"])
def test_resharded_base_reuses_nothing(hub, tmp_path, cold, base_layout):
    """A base tree laid out otherwise than this landing would (every leaf
    replicated, landed over ``{"model": 4}`` for a ``{"data": 2, "model":
    4}`` landing, or on one device): no shard is reused, the base is still
    consumed, and the tree is a cold mesh pull's."""
    axes = MESHES["data2_model4"]
    if base_layout == "another_mesh":
        base = _pull(hub, tmp_path / "d", SHA_A, MESHES["model4"]).params
    elif base_layout == "unsharded":
        base = _pull(hub, tmp_path / "d", SHA_A, axes, mesh=None).params
    else:
        base = _replicated(_pull(hub, tmp_path / "d", SHA_A, axes).params)
    assert base
    res = _pull(hub, tmp_path / "d", SHA_B, axes, base_params=base,
                base_revision=SHA_A)
    want = cold(axes).params
    assert res.stats["hbm"]["swap"]["reused_tensors"] == 0
    assert res.stats["hbm"]["swap"]["landed_tensors"] == len(want)
    assert not base
    assert loader.params_digest(res.params) == loader.params_digest(want)
    for name, t in res.params.items():
        assert t.spec == want[name].spec, name


def test_failed_swap_keeps_the_base(hub, tmp_path, monkeypatch):
    """A sharded commit that fails after its first group: the caller's
    dict holds every reused ``ShardedTensor`` (the same objects, every
    shard in place) and every base tensor not yet superseded, and the
    ``DeltaSwapError`` lists the superseded ones."""
    axes = MESHES["data2_model4"]
    kw = {"land_ring_slots": 4}
    base = _pull(hub, tmp_path, SHA_A, axes, kw).params
    before = dict(base)
    shards = {n: dict(t.shards) for n, t in base.items()}
    popped: list[str] = []

    class Base(dict):
        def pop(self, key, *default):
            popped.append(key)
            return dict.pop(self, key, *default)

    base = Base(base)
    reused: list[str] = []
    committed: list[str] = []
    orig = loader._ShardedCommit.commit

    def commit(self, items):
        if not committed:
            reused.extend(popped)
        elif len(popped) > len(reused):
            raise RuntimeError("commit failed")
        committed.extend(it[0] for it in items)
        return orig(self, items)

    monkeypatch.setattr(loader._ShardedCommit, "commit", commit)
    with pytest.raises(delta.DeltaSwapError, match="commit failed") as ei:
        _pull(hub, tmp_path, SHA_B, axes, kw, base_params=base,
              base_revision=SHA_A)
    err = ei.value
    assert 0 < err.restored == len(reused)
    assert set(reused) <= set(base)
    assert all(base[n] is before[n] for n in base)
    for name in base:
        assert all(base[name].shards[s] is t
                   for s, t in shards[name].items()), name
    gone = sorted(set(before) - set(base))
    assert err.gone == gone and gone
    assert set(gone) <= set(committed) - set(reused)


def test_watch_and_swap_over_a_mesh(tmp_path, monkeypatch):
    """A subscriber whose pulls land over a mesh swaps each pushed revision
    into its sharded tree in place (``watch_and_swap`` takes no new
    argument: its pull lands over the mesh the node's pulls use)."""
    import threading
    import time

    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.transfer.push import push_checkpoint, watch_and_swap

    axes = MESHES["model4"]
    mesh = model_mesh(axes, ["cpu"] * 4)
    monkeypatch.setattr(port_pull, "pull_model", functools.partial(
        port_pull.pull_model, mesh=mesh))
    cfg_a = Config(hf_home=tmp_path / "a" / "hf",
                   cache_dir=tmp_path / "a" / "zest")
    sha_a = push_checkpoint(cfg_a, REPO, files=FILES_A, device="cpu",
                            notify=False, log=_quiet).revision
    seen, errors = [], []
    with PublisherServer(cfg_a) as server:
        cfg_s = Config(hf_home=tmp_path / "s" / "hf",
                       cache_dir=tmp_path / "s" / "zest",
                       endpoint=server.url)
        base = port_pull.pull_model(cfg_s, REPO, device="cpu", no_p2p=True,
                                    log=_quiet).params
        before = dict(base)

        def watch():
            try:
                watch_and_swap(cfg_s, REPO, publisher_url=server.url,
                               device="cpu", base_params=base,
                               base_revision=sha_a, timeout_s=60,
                               on_swap=lambda r, res: seen.append(res),
                               log=_quiet)
            except Exception as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        t = threading.Thread(target=watch)
        t.start()
        deadline = time.monotonic() + 30
        while server.hub.watchers() < 1:
            assert time.monotonic() < deadline and t.is_alive()
            time.sleep(0.02)
        push_checkpoint(cfg_a, REPO, files=FILES_B, base_revision=sha_a,
                        device="cpu", notify_url=server.url, log=_quiet)
        t.join(timeout=120)
    assert not t.is_alive() and not errors and len(seen) == 1, errors
    res = seen[0]
    assert res.stats["mesh"] == axes
    assert 0 < len(_reused(before, res)) == \
        res.stats["hbm"]["swap"]["reused_tensors"]
    assert not base
    want = loader.params_digest(loader.load_checkpoint(res.snapshot_dir,
                                                       "cpu"))
    assert loader.params_digest(res.params) == want
