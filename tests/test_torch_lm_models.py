"""The port's LM model zoo against ``repro``'s, for all ten architectures at
``reduced_config``.

Every parameter is drawn from seeded numpy at ``repro``'s shapes, the
constant-initialised ones included (``models.testing.random_params``), and
the same tree goes to both packages through ``convert``.  For each
architecture: ``forward`` in train mode, prefill into a cache, two decode
steps (the first from ``repro``'s prefill cache converted, the second from
each package's own), their logits and caches, and ``loss_fn``.

Tolerance: rtol 2e-2, atol 2e-2 on f32-cast bf16 outputs (logits, caches,
losses), the reference's own bound for bf16 attention; f32 caches (the
recurrent states) are held to the same bound.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as ARCHS_J
from repro.configs.registry import reduced_config as reduced_config_j
from repro.models import transformer as tf_j
from repro_torch import convert
from repro_torch.configs.registry import ARCHS, reduced_config
from repro_torch.models import transformer as tf
from repro_torch.models.testing import (
    ambiguous_routing, random_extras, random_params, tolerance)

LM_ARCHS = [a for a in ARCHS if a != "tda_ego"]
CPU = torch.device("cpu")
BATCH, SEQ, S_KV = 2, 32, 40
# the share of tokens an MoE comparison must hold (olmoe holds 72% of its
# prefill, phi3.5-moe, with 16 experts and a capacity that binds, 47%)
MIN_HELD = 0.4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    gain nothing from threads, and parallel test workers would
    oversubscribe the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, what, tol, keep=None):
    """Within ``tol`` = (rtol, atol); ``keep`` selects the leading positions
    held (tokens after an ambiguous routing choice are not)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    if keep is not None:
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                               err_msg=what)


def assert_caches_close(got, want, what, tol, keep=None):
    """Leaf by leaf; ``keep`` (B, S_kv) selects the attention-cache rows
    held, on axes 1-2 of every (layers, B, S_kv, ...) leaf."""
    flat_g = jax.tree_util.tree_leaves_with_path(
        convert.lm_caches_to_numpy(got))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], what
    for (path, g), (_, w) in zip(flat_g, flat_w):
        rows = None if keep is None else (slice(None), keep)
        assert_close(g, w, f"{what} {jax.tree_util.keystr(path)}", tol,
                     rows)


def routed(case, fn, off=None):
    """``fn()`` on the port under ``ambiguous_routing``: (its result, the
    (B, S) bool tokens held, those no rounding difference can move beyond
    the tolerance through an expert choice; None outside the MoE family)."""
    with ambiguous_routing(case.model, off) as found:
        out = fn()
    return out, (~found[-1].numpy() if found else None)


class Case:
    """One architecture: both packages' models on one drawn tree, the
    inputs, and ``repro``'s prefill (logits and caches)."""

    def __init__(self, arch, seed):
        self.arch = arch
        self.cfg_j, self.cfg = reduced_config_j(arch), reduced_config(arch)
        self.tol = tolerance(self.cfg)
        tree = random_params(self.cfg, seed)
        self.params_j = jax.tree.map(jnp.asarray, tree)
        self.model = convert.lm_params_from_numpy(tree, self.cfg, device=CPU)
        rng = np.random.default_rng(seed + 1)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32)
        self.next_tokens = rng.integers(0, self.cfg.vocab_size,
                                        (2, BATCH, 1)).astype(np.int32)
        ex = random_extras(self.cfg, BATCH, rng)
        if self.cfg.mrope_sections:
            ex["mrope_positions"] = rng.integers(
                0, 64, (BATCH, SEQ, 3)).astype(np.int32)
            self.mrope_decode = rng.integers(
                0, 64, (2, BATCH, 1, 3)).astype(np.int32)
        self.extras_j = {k: jnp.asarray(v) for k, v in ex.items()}
        self.extras = {k: torch.from_numpy(v) for k, v in ex.items()}
        caches = tf_j.init_caches(self.cfg_j, BATCH, S_KV)
        self.prefill_j = tf_j.forward(
            self.params_j, self.cfg_j, jnp.asarray(self.tokens),
            mode="prefill", caches=caches, **self.extras_j)

    def decode_extras(self, step, jax_side):
        ex = self.extras_j if jax_side else self.extras
        ex = {k: v for k, v in ex.items() if k != "mrope_positions"}
        if self.cfg.mrope_sections:
            mp = self.mrope_decode[step]
            ex["mrope_positions"] = (jnp.asarray(mp) if jax_side
                                     else torch.from_numpy(mp))
        return ex


@pytest.fixture(scope="module", params=LM_ARCHS)
def case(request):
    return Case(request.param, seed=LM_ARCHS.index(request.param))


def test_archs_match_repro():
    assert list(ARCHS) == list(ARCHS_J)


def test_forward_train(case):
    lj, cj = tf_j.forward(case.params_j, case.cfg_j,
                          jnp.asarray(case.tokens), mode="train",
                          **case.extras_j)
    with torch.inference_mode():
        (lt, ct), held = routed(case, lambda: tf.forward(
            case.model, case.cfg, torch.from_numpy(case.tokens),
            mode="train", **case.extras))
    assert cj is None and ct is None
    assert_close(lt.float(), lj, f"{case.arch} train logits", case.tol, held)
    check_coverage(case, held)


def check_coverage(case, held):
    if held is not None:
        assert held.mean() >= MIN_HELD, (case.arch, held.mean())


def test_forward_prefill(case):
    lj, cj = case.prefill_j
    caches = tf.init_caches(case.cfg, BATCH, S_KV, device=CPU)
    with torch.inference_mode():
        (lt, ct), held = routed(case, lambda: tf.forward(
            case.model, case.cfg, torch.from_numpy(case.tokens),
            mode="prefill", caches=caches, **case.extras))
    assert all(ct[name] is caches[name] for name in caches)  # in place
    keep = None
    if held is not None:
        keep = np.ones((BATCH, S_KV), bool)
        keep[:, :SEQ] = held
    assert_close(lt.float(), lj, f"{case.arch} prefill logits", case.tol,
                 held)
    assert_caches_close(ct, jax.tree.map(np.asarray, cj),
                        f"{case.arch} prefill cache", case.tol, keep)
    check_coverage(case, held)


def test_forward_decode(case):
    """Two decode steps: the first from ``repro``'s prefill cache in both
    packages, the second from each package's own cache.  A sequence whose
    routing was ambiguous in a step is not held from then on."""
    _, cj = case.prefill_j
    ct = convert.lm_caches_from_numpy(jax.tree.map(np.asarray, cj),
                                      device=CPU)
    seq_held = np.ones(BATCH, bool)
    for step in range(2):
        pos = SEQ + step
        tok = case.next_tokens[step]
        lj, cj = tf_j.forward(case.params_j, case.cfg_j, jnp.asarray(tok),
                              mode="decode", caches=cj, pos=jnp.int32(pos),
                              **case.decode_extras(step, True))
        with torch.inference_mode():
            (lt, ct), held = routed(case, lambda: tf.forward(
                case.model, case.cfg, torch.from_numpy(tok), mode="decode",
                caches=ct, pos=pos, **case.decode_extras(step, False)),
                off=torch.from_numpy(~seq_held[:, None]))
        keep = rows = None
        if held is not None:
            seq_held = held[:, 0]
            rows = seq_held[:, None]
            keep = np.repeat(rows, S_KV, 1)
        what = f"{case.arch} decode step {step}"
        assert_close(lt.float(), lj, f"{what} logits", case.tol, rows)
        assert_caches_close(ct, jax.tree.map(np.asarray, cj),
                            f"{what} cache", case.tol, keep)


def test_loss_fn(case):
    """The mean over every position: an ambiguous routing choice moves a
    few of its terms."""
    lj = tf_j.loss_fn(case.params_j, case.cfg_j, jnp.asarray(case.tokens),
                      **case.extras_j)
    with torch.inference_mode():
        lt = tf.loss_fn(case.model, case.cfg, torch.from_numpy(case.tokens),
                        **case.extras)
    assert lt.dtype == torch.float32 and lt.shape == ()
    assert_close(lt, lj, f"{case.arch} loss", case.tol)


def test_params_round_trip(case):
    """``convert`` is exact both ways, and the drawn tree has ``repro``'s
    structure and shapes."""
    back = convert.lm_params_to_numpy(case.model)
    want = jax.eval_shape(
        lambda: tf_j.init_params(case.cfg_j, jax.random.PRNGKey(0)))
    assert (jax.tree.structure(back)
            == jax.tree.structure(jax.tree.map(lambda _: 0, want)))
    for (path, a), b, s in zip(jax.tree_util.tree_leaves_with_path(back),
                               jax.tree.leaves(case.params_j),
                               jax.tree.leaves(want)):
        assert a.shape == s.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, np.asarray(b))
