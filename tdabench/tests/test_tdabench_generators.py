"""The cells' generators: the D&D surrogate's published order and size,
the same graphs from the same seed on any device, the ego nets as the
program's own ``ego_batch`` cuts them, and preferential attachment's
invariants."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.ego import ego_batch
from tdabench.gen import common, ego_nets, pa_dataset

ROOT = Path(__file__).resolve().parents[2]
DD = json.loads((ROOT / "tdabench/configs/tu_dd.json").read_text())["data"]
EGO = json.loads((ROOT / "tdabench/configs/tda_ego.json").read_text())["data"]


def test_dd_orders_average_the_published_284_3():
    # before the clip: D&D's published mean and standard deviation
    raw = pa_dataset.orders(DD, clip=False)
    assert raw.size == 1178
    assert abs(raw.mean() - 284.32) < 0.01 and abs(raw.std() - 272.12) < 0.01
    mu, sigma = pa_dataset.fit_lognormal(1178, 284.32, 272.12)
    assert abs(mu - DD["nv_log_mu"]) < 1e-9
    assert abs(sigma - DD["nv_log_sigma"]) < 1e-9
    # the clip: D&D's smallest graph, and the 512 cut
    nv = pa_dataset.orders(DD)
    assert nv.min() == 30 and nv.max() == 512
    assert (raw > 512).sum() == 152
    assert (nv == 512).sum() == (raw >= 512).sum()


def test_dd_edges_at_seed_0_within_2pct_of_715_7():
    torch.set_num_threads(4)
    g = pa_dataset.generate(DD, 0, "cpu")
    edges = g["adj"].sum((-1, -2)).double() / 2
    nv = g["mask"].sum(-1).double()
    # D&D's 715.66 edges to 284.32 vertices, at the clipped sizes
    want = 715.66 / 284.32 * nv.mean().item()
    assert abs(edges.mean().item() / want - 1) < 0.02
    assert np.array_equal(np.sort(g["mask"].sum(-1).numpy()),
                          pa_dataset.orders(DD))
    # the caps hold every unreduced graph
    a = g["adj"].float()
    tri = (torch.bmm(a, a) * a).sum((-1, -2)) / 6
    assert edges.max() <= 2048 and tri.max() <= 1024


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 1])
def test_same_seed_same_graphs(seed):
    p = dict(DD, graphs=6, n_pad=64, nv_max=64)
    a = pa_dataset.generate(p, seed, "cpu")
    b = pa_dataset.generate(p, seed, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = pa_dataset.generate(p, seed + 1, "cpu")
    assert not torch.equal(a["adj"], c["adj"])


def test_ego_nets_as_the_programs_ego_batch():
    p = dict(EGO, host_vertices=300)
    e = torch.from_numpy(ego_nets.host_edges(common.host_rng(4, "t"), 300,
                                             p["m"], p["p_triad"]))
    adj = torch.zeros((300, 300), dtype=torch.bool)
    adj[e[:, 0], e[:, 1]] = True
    adj[e[:, 1], e[:, 0]] = True
    f = adj.sum(-1).float()
    mine = ego_nets.ego_nets(adj, f, 16)
    theirs = ego_batch(adj, f, 16, device="cpu")
    assert torch.equal(mine["adj"], theirs.adj)
    assert torch.equal(mine["mask"], theirs.mask)
    assert torch.equal(mine["f"], theirs.f)
    assert (mine["mask"].sum(-1) <= 16).all()


def test_host_edges_attach_m_earlier_vertices():
    e = ego_nets.host_edges(common.host_rng(1, "h"), 500, 7, 0.9)
    assert (e[:, 1] < e[:, 0]).all()
    assert len({tuple(x) for x in e.tolist()}) == len(e)
    per = np.bincount(e[:, 0], minlength=500)
    assert per.max() <= 7 and per[8:].min() >= 1


def test_ba_edges_merge_repeats():
    g, u, v = common.ba_edges(common.host_rng(2, "b"), np.array([50, 9]), 3,
                              50)
    assert (v < u).all()
    keys = set(zip(g.tolist(), u.tolist(), v.tolist()))
    assert len(keys) == len(g)
    assert (u[g == 1] < 9).all()


def test_uniform_is_a_function_of_seed_and_keys():
    k = torch.arange(1000)
    a = common.uniform(7, 1, k)
    assert torch.equal(a, common.uniform(7, 1, k))
    assert not torch.equal(a, common.uniform(8, 1, k))
    assert 0 <= a.min() and a.max() < 1 and abs(a.mean().item() - 0.5) < 0.05
