"""The port's partitioning rules (``launch/sharding.py``) against
``repro``'s, exactly.

For all ten LM configs at full width: every parameter's spec over the meta
model equals ``repro``'s ``param_specs`` of ``jax.eval_shape(init_params)``
with the stacked layer dimensions dropped, and AdamW's specs likewise;
``batch_spec`` and ``cache_specs`` for each of the four ``SHAPES`` on both
production meshes, ``repro``'s side on a ``jax.sharding.AbstractMesh``
(no devices needed); the per-device bytes of parameters, AdamW state and
caches (``shard_bytes``) equal the sums of
``NamedSharding(AbstractMesh, spec).shard_shape`` bytes from ``repro``'s
specs; the index specs; and the new modules import neither ``jax`` nor
``repro``.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config as get_config_j
from repro.launch import sharding as sh_j
from repro.models import transformer as tf_j
from repro.models.config import SHAPES as SHAPES_J
from repro.train.optimizer import adamw_init as adamw_init_j
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.convert import _tree_path
from repro_torch.launch import sharding as sh
from repro_torch.launch.dryrun import production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.config import SHAPES
from repro_torch.train.optimizer import adamw_init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ARCHS if a != "tda_ego"]
META = torch.device("meta")
MESHES = {
    False: AbstractMesh((16, 16), ("data", "model")),
    True: AbstractMesh((2, 16, 16), ("pod", "data", "model")),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: parallel test workers would oversubscribe the
    CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(entry) -> str:
    return str(entry.key if hasattr(entry, "key") else entry.name)


def _flat_specs(specs) -> dict:
    """{path of keys: PartitionSpec} of ``repro``'s spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(e) for e in path): s for path, s in leaves}


def _flat_shapes(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(_key(e) for e in path): x for path, x in leaves}


def _entries(spec: P, ndim: int) -> tuple:
    """A PartitionSpec as the port's tuple: one entry a dimension."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _shard_bytes_j(tree, specs, mesh) -> int:
    shapes = _flat_shapes(tree)
    flat = _flat_specs(specs)
    return sum(math.prod(NamedSharding(mesh, flat[k]).shard_shape(x.shape))
               * np.dtype(x.dtype).itemsize for k, x in shapes.items())


_PARAMS_J: dict = {}


def _params_j(arch):
    if arch not in _PARAMS_J:
        cfg = get_config_j(arch)
        _PARAMS_J[arch] = jax.eval_shape(
            lambda: tf_j.init_params(cfg, jax.random.PRNGKey(0)))
    return _PARAMS_J[arch]


def _port_specs_vs_repro(named_specs: dict, specs_j, shapes_j) -> None:
    """Every port spec (by parameter name) equals ``repro``'s spec of the
    stacked leaf with the stack dimensions dropped, which must be
    replicated; every leaf of ``repro``'s tree is covered."""
    flat = _flat_specs(specs_j)
    covered = set()
    for name, spec in named_specs.items():
        path, idx = _tree_path(name)
        want = _entries(flat[path], len(shapes_j[path].shape))
        assert want[:len(idx)] == (None,) * len(idx), (name, want)
        assert spec == want[len(idx):], (name, spec, want)
        covered.add(path)
    assert covered == set(flat)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_opt_specs_equal_repros(arch):
    model = tf.Model(get_config(arch), None, META)
    pspecs = sh.param_specs(model)
    params_j = _params_j(arch)
    specs_j = sh_j.param_specs(params_j)
    _port_specs_vs_repro(pspecs, specs_j, _flat_shapes(params_j))

    ospecs = sh.opt_specs(pspecs)
    ospecs_j = sh_j.opt_specs(specs_j)
    assert ospecs.step == () and tuple(ospecs_j.step) == ()
    opt_shapes = _flat_shapes(jax.eval_shape(adamw_init_j, params_j))
    for field in ("m", "v"):
        assert getattr(ospecs, field) == pspecs
        _port_specs_vs_repro(
            getattr(ospecs, field), getattr(ospecs_j, field),
            {k[1:]: v for k, v in opt_shapes.items() if k[0] == field})


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_and_cache_specs_equal_repros(shape, multi_pod):
    mesh, mesh_j = production_mesh(multi_pod), MESHES[multi_pod]
    sc = SHAPES[shape]
    assert sh.batch_spec(sc.global_batch, mesh) == tuple(
        sh_j.batch_spec(sc.global_batch, mesh_j))
    for b in (1, 8, 256):  # both sides of the batch fallback too
        assert sh.batch_spec(b, mesh) == tuple(sh_j.batch_spec(b, mesh_j))
    for arch in LM_ARCHS:
        cfg, cfg_j = get_config(arch), get_config_j(arch)
        caches = tf.init_caches(cfg, sc.global_batch, sc.seq_len, device=META)
        caches_j = jax.eval_shape(
            lambda: tf_j.init_caches(cfg_j, sc.global_batch, sc.seq_len))
        cspecs = sh.cache_specs(caches, cfg, mesh, sc.global_batch)
        flat_j = _flat_specs(sh_j.cache_specs(caches_j, cfg_j, mesh_j,
                                              sc.global_batch))
        shapes_j = _flat_shapes(caches_j)
        got = {tuple(_key(e) for e in path): s for path, s in
               jax.tree_util.tree_flatten_with_path(
                   cspecs, is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert set(got) == set(flat_j), arch
        for k, spec in got.items():
            assert spec == _entries(flat_j[k], len(shapes_j[k].shape)), (
                arch, k)
        assert sh.shard_bytes(caches, cspecs, mesh) == _shard_bytes_j(
            caches_j, sh_j.cache_specs(caches_j, cfg_j, mesh_j,
                                       sc.global_batch), mesh_j), arch


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shard_bytes_of_params_and_adamw_equal_repros(arch, multi_pod):
    mesh, mesh_j = production_mesh(multi_pod), MESHES[multi_pod]
    model = tf.Model(get_config(arch), None, META)
    pspecs = sh.param_specs(model)
    params_j = _params_j(arch)
    specs_j = sh_j.param_specs(params_j)
    want = _shard_bytes_j(params_j, specs_j, mesh_j)
    assert sh.shard_bytes(model, pspecs, mesh) == want
    opt = adamw_init(model)
    opt_j = jax.eval_shape(adamw_init_j, params_j)
    assert sh.shard_bytes(opt, sh.opt_specs(pspecs), mesh) == _shard_bytes_j(
        opt_j, sh_j.opt_specs(specs_j), mesh_j)


def test_shard_shape_follows_named_sharding():
    mesh, mesh_j = production_mesh(True), MESHES[True]
    for shape, spec in (((64, 48), (("pod", "data"), "model")),
                        ((32, 16, 7), ("data",)),
                        ((512, 3), (("pod", "data", "model"), None)),
                        ((5,), (None,)), ((), ())):
        assert sh.shard_shape(shape, spec, mesh) == NamedSharding(
            mesh_j, P(*spec)).shard_shape(shape)
    with pytest.raises(ValueError):
        sh.shard_shape((8, 3), ("model",), mesh)
    with pytest.raises(ValueError):
        NamedSharding(mesh_j, P("model")).shard_shape((8, 3))


def test_index_specs_equal_repros():
    assert sh.index_row_spec() == tuple(sh_j.index_row_spec())
    assert sh.index_gram_specs() == tuple(
        tuple(s) for s in sh_j.index_gram_specs())


def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch, repro_torch.launch.sharding, "
            "repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.roofline_report\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
