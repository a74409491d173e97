"""Filtered clique complex (counterpart of ``repro.core.filtration``).

``build_filtered_complex`` builds, for every graph of a batch at once, the
static-capacity table of simplices (vertices, edges, triangles, tetrahedra)
in sorted filtration order, with the same caps, slot layout, ``-1`` face
padding and (value, dim, slot) order as the JAX version, which builds one
graph under ``vmap``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import INF


@dataclasses.dataclass(frozen=True)
class FilteredComplex:
    """Static-capacity filtered clique complexes of a batch of graphs.

    All arrays are (B, S, ...) in sorted filtration order (value asc, dim
    asc, slot asc):
      values:   (B, S) f32, +inf for padding slots.
      dims:     (B, S) i32 simplex dimension (-1 padding).
      valid:    (B, S) bool.
      face_pos: (B, S, 4) i32 sorted positions of boundary faces (-1 unused).
    """

    values: torch.Tensor
    dims: torch.Tensor
    valid: torch.Tensor
    face_pos: torch.Tensor

    @property
    def size(self) -> int:
        return self.values.shape[-1]


def _first_k_indices(flat: torch.Tensor, cap: int):
    """Indices (ascending) of the first ``cap`` set entries of each row of
    ``flat`` (B, U) bool, and their validity; invalid slots hold index 0."""
    b = flat.shape[0]
    pos = flat.cumsum(-1, dtype=torch.int32) - 1
    row, col = (flat & (pos < cap)).nonzero(as_tuple=True)
    idx = torch.zeros((b, cap), dtype=torch.int64, device=flat.device)
    idx[row, pos[row, col].long()] = col
    count = flat.sum(-1, dtype=torch.int64)
    valid = torch.arange(cap, device=flat.device)[None, :] < count[:, None]
    return idx, valid


def _lookup(keys: torch.Tensor, valid: torch.Tensor, query: torch.Tensor):
    """Slot of each ``query`` key among the valid, ascending ``keys`` of its
    row, or -1 when absent."""
    big = torch.iinfo(torch.int64).max
    keys = torch.where(valid, keys, big).contiguous()
    pos = torch.searchsorted(keys, query.contiguous())
    cap = keys.shape[-1]
    hit = keys.gather(-1, pos.clamp(max=max(cap - 1, 0))) == query
    return torch.where((pos < cap) & hit, pos, -1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered at idx (B, K) along axis 1 -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def build_filtered_complex(adj: torch.Tensor, mask: torch.Tensor,
                           f: torch.Tensor, max_dim: int, edge_cap: int,
                           tri_cap: int, quad_cap: int = 0,
                           sublevel: bool = True) -> FilteredComplex:
    """Sorted filtered clique complex of every graph in the batch.

    Simplices up to dimension max_dim + 1 enter (the deaths of max_dim
    classes).  Caps are static; simplices past a cap are dropped exactly as
    in the JAX version (the first ``cap`` in index order are kept).
    """
    dev = adj.device
    b, n = mask.shape
    fv = torch.where(mask, f if sublevel else -f, INF)
    adjm = adj & mask[:, None, :] & mask[:, :, None]
    iu = torch.arange(n, device=dev)

    # --- edges (dim 1): the set bits of the upper triangle, row-major ---
    upper = adjm & (iu[:, None] < iu[None, :])
    e_flat, e_valid = _first_k_indices(upper.reshape(b, n * n), edge_cap)
    eu, ev = e_flat // n, e_flat % n
    e_val = torch.where(e_valid, torch.maximum(fv.gather(1, eu),
                                               fv.gather(1, ev)), INF)
    slots_values = [fv, e_val]
    slots_dims = [torch.zeros(n, dtype=torch.int32, device=dev),
                  torch.ones(edge_cap, dtype=torch.int32, device=dev)]
    slots_valid = [mask, e_valid]

    # triangles {i<j<k} are found once, on edge (i, j) with third vertex k > j;
    # the boolean row gather replaces the JAX version's bf16 one-hot einsum
    t_cap = tri_cap if max_dim >= 1 else 0
    if t_cap:
        third = (_rows(adjm, eu) & _rows(adjm, ev)
                 & (iu[None, None, :] > ev[:, :, None])
                 & e_valid[:, :, None])
        t_flat, t_valid = _first_k_indices(third.reshape(b, -1), t_cap)
        te = t_flat // n
        ti, tj, tk = eu.gather(1, te), ev.gather(1, te), t_flat % n
        t_val = torch.where(t_valid, torch.maximum(
            torch.maximum(fv.gather(1, ti), fv.gather(1, tj)),
            fv.gather(1, tk)), INF)
        slots_values.append(t_val)
        slots_dims.append(torch.full((t_cap,), 2, dtype=torch.int32,
                                     device=dev))
        slots_valid.append(t_valid)

    q_cap = quad_cap if max_dim >= 2 else 0
    if q_cap:
        fourth = (_rows(adjm, ti) & _rows(adjm, tj) & _rows(adjm, tk)
                  & (iu[None, None, :] > tk[:, :, None])
                  & t_valid[:, :, None])
        q_flat, q_valid = _first_k_indices(fourth.reshape(b, -1), q_cap)
        qt = q_flat // n
        qi, qj, qk = ti.gather(1, qt), tj.gather(1, qt), tk.gather(1, qt)
        ql = q_flat % n
        q_val = torch.where(q_valid, torch.maximum(
            torch.maximum(fv.gather(1, qi), fv.gather(1, qj)),
            torch.maximum(fv.gather(1, qk), fv.gather(1, ql))), INF)
        slots_values.append(q_val)
        slots_dims.append(torch.full((q_cap,), 3, dtype=torch.int32,
                                     device=dev))
        slots_valid.append(q_valid)

    values = torch.cat(slots_values, dim=1)
    dims = torch.cat(slots_dims)[None, :].expand(b, -1)
    valid = torch.cat(slots_valid, dim=1)
    s_total = values.shape[1]

    # --- filtration order (value, dim, slot): stable sorts, least
    # significant key first; slot order is the starting order ---
    perm = torch.sort(dims, dim=1, stable=True).indices
    perm = perm.gather(1, torch.sort(values.gather(1, perm), dim=1,
                                     stable=True).indices)
    slot_ids = torch.arange(s_total, dtype=torch.int32,
                            device=dev).expand(b, -1)
    pos_of_slot = torch.empty_like(slot_ids).scatter_(1, perm, slot_ids)

    # --- face slots per unsorted slot ---
    face_slot = torch.full((b, s_total, 4), -1, dtype=torch.int32, device=dev)
    face_slot[:, n:n + edge_cap, 0] = torch.where(e_valid, eu, -1).to(
        torch.int32)
    face_slot[:, n:n + edge_cap, 1] = torch.where(e_valid, ev, -1).to(
        torch.int32)
    if t_cap:
        edge_key = eu * n + ev  # ascending over the valid edges

        def edge_id(x, y):
            return _lookup(edge_key, e_valid, x * n + y)

        base = n + edge_cap
        for c, fid in enumerate((edge_id(ti, tj), edge_id(ti, tk),
                                 edge_id(tj, tk))):
            face_slot[:, base:base + t_cap, c] = torch.where(
                t_valid & (fid >= 0), n + fid, -1).to(torch.int32)
    if q_cap:
        tri_key = (ti * n + tj) * n + tk  # ascending over the valid triangles

        def tri_id(x, y, z):
            return _lookup(tri_key, t_valid, (x * n + y) * n + z)

        base = n + edge_cap + t_cap
        for c, gid in enumerate((tri_id(qi, qj, qk), tri_id(qi, qj, ql),
                                 tri_id(qi, qk, ql), tri_id(qj, qk, ql))):
            face_slot[:, base:base + q_cap, c] = torch.where(
                q_valid & (gid >= 0), n + edge_cap + gid, -1).to(torch.int32)

    # --- reorder into sorted position space ---
    valid_s = valid.gather(1, perm)
    values_s = values.gather(1, perm)
    dims_s = torch.where(valid_s, dims.gather(1, perm), -1)
    fs = face_slot.gather(1, perm[:, :, None].expand(-1, -1, 4))
    face_pos = torch.where(
        fs >= 0,
        pos_of_slot.gather(1, fs.clamp(min=0).reshape(b, -1).long())
        .reshape(b, s_total, 4), -1)
    return FilteredComplex(values=values_s.contiguous(),
                           dims=dims_s.contiguous(),
                           valid=valid_s.contiguous(),
                           face_pos=face_pos.contiguous())


def complex_caps_ok(adj: torch.Tensor, mask: torch.Tensor, edge_cap: int,
                    tri_cap: int, quad_cap: int = 0,
                    max_dim: int = 1) -> torch.Tensor:
    """(B,) bool: the static capacities hold every simplex of the graph."""
    adjm = adj & mask[:, None, :] & mask[:, :, None]
    ok = adjm.sum((-1, -2), dtype=torch.int64) // 2 <= edge_cap
    if max_dim >= 1:
        a = adjm.float()
        # A^2 entries are <= N, exact in f32; the sum runs in f64
        tri = (torch.bmm(a, a) * a).sum((-1, -2), dtype=torch.float64) / 6.0
        ok = ok & (tri <= tri_cap)
    if max_dim >= 2 and quad_cap:
        # a 4-clique i<j<k<l is an edge (i, j) plus an edge (k, l) inside
        # the common neighbours of i and j above j
        n = adj.shape[-1]
        iu = torch.arange(n, device=adj.device)
        up = adjm & (iu[:, None] < iu[None, :])
        x = (adjm[:, :, None, :] & adjm[:, None, :, :]
             & (iu[None, None, :, None] < iu[None, None, None, :])
             & up[:, :, :, None]).float()
        quad = torch.einsum("bijk,bkl,bijl->b", x, up.float(), x)
        ok = ok & (quad <= quad_cap)
    return ok
