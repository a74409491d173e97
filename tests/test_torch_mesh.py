"""The port's device meshes, mesh-sharded plans and ``TopoServe(mesh=)``
against ``repro``'s.

The mesh constructors' shapes, axis names, ``flat`` order and guards
(``make_serve_mesh()`` / ``make_test_mesh()`` beside ``repro``'s on the one
CPU device where both exist).  ``topological_signature_sharded`` on 1-4
CPU shards is bitwise the port's unsharded call and ``repro``'s sharded
call on ``make_serve_mesh()`` and ``make_test_mesh()`` for every method and
both orientations; a subprocess runs ``repro``'s path on a 4-device serve
mesh (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and its
Diagrams are bitwise the port's on 4 CPU shards.  ``TopoServe(mesh=)``
pads its batches to the mesh size and serves ``repro``'s meshed server's
Diagrams; ``tda_ego.config()`` is ``repro``'s field for field.  ``repro``
runs with its jnp reducer; the port on the CPU (its plain kernel versions).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.serve as serve_j
from repro.configs import tda_ego as tda_ego_j
from repro.core import api as api_j
from repro.launch import mesh as mesh_j
from repro_torch.configs import tda_ego
from repro_torch.convert import diagrams_arrays, graph_batch_from_numpy
from repro_torch.core import api
from repro_torch.core.persistence import diagrams_bitwise_equal
from repro_torch.launch import (
    DeviceMesh,
    IndexMesh,
    make_production_mesh,
    make_serve_mesh,
    make_test_mesh,
)
from repro_torch.serve import Bucket, TopoServe, TopoServeConfig
from repro_torch.serve import topo_serve
from tests.conftest import graphs_to_batch, random_graphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CAPS = dict(edge_cap=96, tri_cap=160)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batches():
    """12 graphs (every shard count 1-4 divides it) from the conftest
    generators, as a ``repro`` and a port GraphBatch."""
    gs = (random_graphs("er", 4, seed=21) + random_graphs("ba", 4, seed=22)
          + random_graphs("plc", 4, seed=23))
    gj = graphs_to_batch(gs, n_pad=24)
    arrays = tuple(np.asarray(x) for x in (gj.adj, gj.mask, gj.f))
    return gj, graph_batch_from_numpy(*arrays, device="cpu"), arrays


def _cpu(n):
    return ["cpu"] * n


# ----------------------------------------------------------------- meshes

@pytest.mark.parametrize("name", ["serve", "test"])
def test_one_device_meshes_match_repro(name):
    if name == "serve":
        got, want = make_serve_mesh(devices=_cpu(1)), mesh_j.make_serve_mesh()
    else:
        got, want = make_test_mesh(devices=_cpu(1)), mesh_j.make_test_mesh()
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == want.devices.size == 1
    assert got.flat == [CPU]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_serve_mesh_shape_and_flat_order(n):
    devs = [torch.device("cpu", i) for i in range(n)]
    mesh = make_serve_mesh(devices=devs)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": n}
    assert mesh.size == n and mesh.flat == devs
    assert make_serve_mesh(n_devices=1, devices=devs).flat == devs[:1]
    if n % 2:
        with pytest.raises(ValueError, match="even"):
            make_serve_mesh(multi_pod=True, devices=devs)
    else:
        pod = make_serve_mesh(multi_pod=True, devices=devs)
        assert pod.axis_names == ("pod", "data")
        assert pod.shape == {"pod": 2, "data": n // 2}
        assert pod.flat == devs  # row-major: pod 0's devices first
        assert pod.devices == (tuple(devs[:n // 2]), tuple(devs[n // 2:]))


def test_test_and_production_meshes():
    devs = [torch.device("cpu", i) for i in range(6)]
    mesh = make_test_mesh((2, 3), ("data", "model"), devices=devs)
    assert mesh.shape == {"data": 2, "model": 3} and mesh.flat == devs
    assert make_test_mesh(devices=devs).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_test_mesh((2, 4), devices=devs)  # larger than the devices
    with pytest.raises(ValueError):
        make_test_mesh((2, 3), ("data",), devices=devs)
    prod = make_production_mesh(devices=_cpu(256))
    assert prod.axis_names == ("data", "model")
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    pods = make_production_mesh(multi_pod=True, devices=_cpu(512))
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(pods.flat) == 512
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=_cpu(255))
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, devices=_cpu(256))


def test_meshes_are_hashable_plan_keys():
    a, b = make_serve_mesh(devices=_cpu(2)), make_serve_mesh(devices=_cpu(2))
    assert a == b and hash(a) == hash(b) and isinstance(a, DeviceMesh)
    assert a != make_serve_mesh(devices=_cpu(4))
    assert isinstance(IndexMesh(a.devices + a.devices), DeviceMesh)
    plan = api.make_topo_plan(mesh=a)
    assert api.make_topo_plan(mesh=b) is plan
    assert api.make_topo_plan() is not plan and plan.key.mesh == a


def test_constructors_raise_without_cuda_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_serve_mesh, make_test_mesh, make_production_mesh,
                 lambda: make_serve_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="devices="):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopoServe()


# ------------------------------------------------------------ the sharded plan

@pytest.mark.parametrize("sublevel", [True, False])
@pytest.mark.parametrize("method", ["none", "coral", "prunit", "both"])
def test_sharded_signature_bitwise_unsharded_and_repro(batches, method,
                                                       sublevel):
    gj, gt, _ = batches
    kw = dict(dim=1, method=method, sublevel=sublevel, **CAPS)
    want = api.topological_signature(gt, **kw)
    for p in (1, 2, 3, 4):
        got = api.topological_signature_sharded(
            gt, make_serve_mesh(devices=_cpu(p)), **kw)
        assert diagrams_bitwise_equal(got, want), p
        assert got.birth.device == CPU
    for mesh in (mesh_j.make_serve_mesh(), mesh_j.make_test_mesh()):
        d_j = api_j.topological_signature_sharded(gj, mesh, reducer="jnp",
                                                  **kw)
        assert diagrams_bitwise_equal(want, d_j)
    # the (1, 1) test mesh and a (2, 2) mesh shard over every axis
    got = api.topological_signature_sharded(
        gt, make_test_mesh((2, 2), devices=_cpu(4)), **kw)
    assert diagrams_bitwise_equal(got, want)


def test_sharded_plan_refusals(batches):
    _, gt, _ = batches
    mesh = make_serve_mesh(devices=_cpu(4))
    with pytest.raises(ValueError, match="not evenly divisible"):
        api.topological_signature_sharded(gt.index(torch.arange(6)), mesh)
    with pytest.raises(ValueError) as err:
        api.make_topo_plan(repack="on", mesh=mesh)
    with pytest.raises(ValueError) as err_j:
        api_j.make_topo_plan(repack="on", mesh=mesh_j.make_serve_mesh())
    assert str(err.value) == str(err_j.value)


def test_sharded_plan_runs_each_shard_on_its_device(batches, monkeypatch):
    """Shard p (rows p*per..) runs on ``mesh.flat[p]``; the Diagrams come
    back in input order on the batch's device."""
    _, gt, _ = batches
    seen = []
    pipeline = api._pipeline

    def spy(g, key):
        seen.append((g.device, g.f.clone()))
        return pipeline(g, key)

    monkeypatch.setattr(api, "_pipeline", spy)
    devs = [torch.device("cpu", i) for i in range(3)]
    api.topological_signature_sharded(gt, make_serve_mesh(devices=devs),
                                      **CAPS)
    assert [d for d, _ in seen] == [CPU] * 3  # CPU tensors drop the index
    for p, (_, f) in enumerate(seen):
        assert torch.equal(f, gt.f[4 * p:4 * (p + 1)])


_REPRO_FOUR = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from repro.core.api import topological_signature_sharded
    from repro.core.graph import GraphBatch
    from repro.launch.mesh import make_serve_mesh

    src, dst = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    x = np.load(src)
    g = GraphBatch(adj=x["adj"], mask=x["mask"], f=x["f"])
    mesh = make_serve_mesh()
    out = {}
    for method, sub in (("both", True), ("prunit", False)):
        d = topological_signature_sharded(
            g, mesh, dim=1, method=method, sublevel=sub, edge_cap=96,
            tri_cap=160, reducer="jnp")
        for k in ("birth", "death", "dim", "valid"):
            out[f"{method}_{k}"] = np.asarray(getattr(d, k))
    try:
        topological_signature_sharded(
            GraphBatch(adj=x["adj"][:6], mask=x["mask"][:6], f=x["f"][:6]),
            mesh)
    except ValueError:
        out["six_raises"] = np.ones(1, bool)
    np.savez(dst, **out)
""")


def test_four_device_repro_mesh_bitwise_four_cpu_shards(batches, tmp_path):
    """``repro`` on a 4-device serve mesh (a fresh process: XLA fixes its
    host device count at first use) against the port's 4 CPU shards."""
    _, gt, (adj, mask, f) = batches
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, adj=adj, mask=mask, f=f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _REPRO_FOUR, str(src),
                          str(dst)], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    want = np.load(dst)
    assert want["six_raises"].all()
    mesh = make_serve_mesh(devices=_cpu(4))
    for method, sub in (("both", True), ("prunit", False)):
        got = diagrams_arrays(api.topological_signature_sharded(
            gt, mesh, dim=1, method=method, sublevel=sub, **CAPS))
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[f"{method}_{k}"])


# ------------------------------------------------------------- TopoServe

BUCKETS = (Bucket(n_pad=16, edge_cap=64, tri_cap=96),
           Bucket(n_pad=32, edge_cap=160, tri_cap=256))


def _traffic(seed, count):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(3, 31))
        p = float(rng.uniform(0.1, 0.35 if n > 16 else 0.6))
        iu, iv = np.nonzero(np.triu(rng.random((n, n)) < p, 1))
        out.append(([(int(u), int(v)) for u, v in zip(iu, iv)], n))
    return out


def _config(**kw):
    return TopoServeConfig(buckets=BUCKETS, method="both", max_batch=8,
                           record_batches=True, **kw)


def test_serve_mesh_pads_to_mesh_multiple_and_refuses():
    mesh = make_serve_mesh(devices=_cpu(4))
    assert TopoServe(_config(pad_batch_to=6), mesh=mesh)._pad_batch_to == 8
    assert TopoServe(_config(pad_batch_to=1), mesh=mesh)._pad_batch_to == 4
    srv = TopoServe(_config(), device="cpu", mesh=mesh)
    assert srv.device == CPU and srv.mesh is mesh
    with pytest.raises(ValueError) as err:
        TopoServe(_config(repack="on"), mesh=mesh)
    with pytest.raises(ValueError) as err_j:
        serve_j.TopoServe(serve_j.TopoServeConfig(repack="on"),
                          mesh=mesh_j.make_serve_mesh())
    assert str(err.value) == str(err_j.value)
    with pytest.raises(ValueError, match="disagrees"):
        TopoServe(_config(), device="cuda", mesh=mesh)
    assert topo_serve._same_device(CPU, torch.device("cpu", 3))


def test_meshed_server_bitwise_repro_and_unmeshed():
    """17 requests in chunks of at most 8: on 4 CPU shards every batch is
    padded to a multiple of 4 (the pad rows counted), and every served
    Diagrams is bitwise the port's unmeshed server's and ``repro``'s
    meshed server's on ``make_serve_mesh()``."""
    reqs = _traffic(5, 17)
    meshed = TopoServe(_config(), mesh=make_serve_mesh(devices=_cpu(4)))
    one = TopoServe(_config(), mesh=make_serve_mesh(devices=_cpu(1)))
    plain = TopoServe(_config(), device="cpu")
    srv_j = serve_j.TopoServe(serve_j.TopoServeConfig(
        buckets=tuple(serve_j.Bucket(b.n_pad, b.edge_cap, b.tri_cap)
                      for b in BUCKETS),
        method="both", max_batch=8, record_batches=True, reducer="jnp"),
        mesh=mesh_j.make_serve_mesh())
    futs = {s: [s.submit(e, n) for e, n in reqs]
            for s in (meshed, one, plain, srv_j)}
    for s in futs:
        assert s.drain() == len(reqs)
    for i in range(len(reqs)):
        got = futs[meshed][i].result(timeout=0)
        assert diagrams_bitwise_equal(got, futs[plain][i].result(timeout=0))
        assert diagrams_bitwise_equal(got, futs[one][i].result(timeout=0))
        assert diagrams_bitwise_equal(got, futs[srv_j][i].result(timeout=0))
    sizes = [len(r) for _, r, _ in meshed.executed_batches]
    assert sizes == [len(r) for _, r, _ in srv_j.executed_batches]
    assert meshed.stats["padded_rows"] == sum((-n) % 4 for n in sizes) > 0
    assert one.stats["padded_rows"] == srv_j.stats["padded_rows"] == 0
    assert meshed.stats["batches"] == srv_j.stats["batches"]


# --------------------------------------------------------- config, imports

def test_tda_ego_config_matches_repro():
    got, want = tda_ego.config(), tda_ego_j.config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    assert (got.n_pad, got.graphs_per_device, got.edge_cap, got.tri_cap,
            got.sublevel) == (64, 64, 512, 1024, False)


def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch, repro_torch.core.api, "
            "repro_torch.configs, repro_torch.serve.topo_serve, "
            "repro_torch.core.persistence_ref, repro_torch.models, "
            "repro_torch.models.transformer, repro_torch.models.testing, "
            "repro_torch.configs.registry, repro_torch.data.tokens, "
            "repro_torch.serve.serve_step, repro_torch.convert, "
            "repro_torch.train, repro_torch.train.optimizer, "
            "repro_torch.train.train_step, repro_torch.train.checkpoint, "
            "repro_torch.train.testing, repro_torch.launch.train\n"
            "from repro_torch.configs.registry import ARCHS, get_config\n"
            "[get_config(a) for a in ARCHS]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
