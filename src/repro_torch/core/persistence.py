"""Bit-packed GF(2) persistence (counterpart of
``repro.core.persistence_jax``).

The boundary matrix of each filtered clique complex is packed 32 rows per
``int32`` word (bit patterns; bit 31 is the sign bit) and reduced by the
standard pivot chase.  By default every dimension is its own block
(``pack_boundary_blocks``): the dim-d columns only have dim-(d-1) rows.  The
reduction goes through :func:`repro_torch.kernels.ops.gf2_reduce_blocks`:
on CUDA one launch of the ``gf2_reduce`` kernel reduces every block of every
graph; on the CPU the plain version runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.filtration import FilteredComplex, build_filtered_complex
from repro_torch.core.graph import GraphBatch
from repro_torch.kernels import ops, ref

WORD = 32
REDUCERS = ("blocks", "flat")


def _to_bit_pattern(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _pack(rows: torch.Tensor, ok: torch.Tensor, n_cols: int,
          n_words: int) -> torch.Tensor:
    """(B, C, F) row indices with validity -> (B, C, n_words) int32 words.

    Distinct faces are distinct bits, so a sum of the bit values is their OR.
    """
    b = rows.shape[0]
    r = torch.where(ok, rows, 0).long()
    word = torch.where(ok, r // WORD, 0)
    contrib = torch.where(ok, torch.ones_like(r) << (r % WORD), 0)
    out = torch.zeros((b, n_cols, n_words), dtype=torch.int64,
                      device=rows.device)
    out.scatter_add_(2, word, contrib)
    return _to_bit_pattern(out)


def pack_boundary(fc: FilteredComplex) -> torch.Tensor:
    """(B, S, W) int32 packed boundary columns in sorted filtration order."""
    s = fc.size
    return _pack(fc.face_pos, fc.face_pos >= 0, s, (s + WORD - 1) // WORD)


def reduce_packed(b: torch.Tensor, n_rows: int | None = None):
    """The plain reduction of (B, S, W) packed matrices -> (owner, positive).

    owner (B, R) int32: the column that kills row i, or -1; positive (B, S)
    bool: column reduced to zero (a birth).  R = ``n_rows`` (default S).
    """
    _, owner, positive = ref.gf2_reduce_ref(b, n_rows)
    return owner, positive


def _block_caps(n: int, edge_cap: int, tri_cap: int,
                quad_cap: int) -> list[int]:
    caps = [n, edge_cap]
    if tri_cap:
        caps.append(tri_cap)
    if quad_cap:
        caps.append(quad_cap)
    return caps


def pack_boundary_blocks(fc: FilteredComplex, caps: list[int]):
    """Per-dimension packed boundary blocks.

    Returns (blocks, ranks, pos_of_rank):
      blocks[d-1]: (B, caps[d], W_{d-1}) int32 for d >= 1, columns in
                   within-dim filtration (rank) order;
      ranks: (B, S) i32 within-dim rank of each sorted position;
      pos_of_rank[d]: (B, caps[d]) i32 sorted position of each rank (-1 pad).
    """
    b, s = fc.dims.shape
    dev = fc.dims.device
    ranks = torch.zeros((b, s), dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    pos_of_rank = []
    for d, cap in enumerate(caps):
        sel = fc.dims == d
        r_d = sel.cumsum(-1, dtype=torch.int32) - 1
        ranks = torch.where(sel, r_d, ranks)
        por = torch.full((b, cap + 1), -1, dtype=torch.int32, device=dev)
        por.scatter_(1, torch.where(sel, r_d, cap).long(),
                     torch.where(sel, pos, -1))
        pos_of_rank.append(por[:, :cap].contiguous())

    blocks = []
    for d in range(1, len(caps)):
        por = pos_of_rank[d]
        fp = fc.face_pos.gather(
            1, por.clamp(min=0).long()[:, :, None].expand(-1, -1, 4))[..., :d + 1]
        ok = (fp >= 0) & (por >= 0)[:, :, None]
        r = ranks.gather(1, fp.clamp(min=0).reshape(b, -1).long()).reshape(
            fp.shape)
        blocks.append(_pack(r, ok, caps[d], (caps[d - 1] + WORD - 1) // WORD))
    return blocks, ranks, pos_of_rank


def reduce_packed_blocks(fc: FilteredComplex, caps: list[int]):
    """Per-dimension block reduction -> global (owner (B,S), positive (B,S)).

    Every block goes to one ``gf2_reduce_blocks`` call (one kernel launch on
    CUDA).
    """
    blocks, _, pos_of_rank = pack_boundary_blocks(fc, caps)
    reduced = ops.gf2_reduce_blocks(blocks, caps[:-1])
    b, s = fc.dims.shape
    dev = fc.dims.device
    owner = torch.full((b, s + 1), -1, dtype=torch.int32, device=dev)
    positive = torch.zeros((b, s + 1), dtype=torch.bool, device=dev)
    positive[:, :s] = fc.dims == 0  # vertices are always births
    for d in range(1, len(caps)):
        _, own_d, pos_d = reduced[d - 1]
        killed = own_d >= 0
        row_pos = pos_of_rank[d - 1]
        col_pos = pos_of_rank[d].gather(1, own_d.clamp(min=0).long())
        owner.scatter_(1, torch.where(killed, row_pos, s).long(),
                       torch.where(killed, col_pos, -1))
        cpos = pos_of_rank[d]
        cvalid = cpos >= 0
        positive.scatter_(1, torch.where(cvalid, cpos, s).long(),
                          pos_d & cvalid)
    return owner[:, :s], positive[:, :s]


@dataclasses.dataclass(frozen=True)
class Diagrams:
    """Fixed-size persistence diagram tensors, (B, S) each.

    Each birth simplex position contributes one row: birth/death f32
    (death = +inf for essential classes), dim i32, valid bool.  Invalid rows
    hold NaN birth/death and dim -1.
    """

    birth: torch.Tensor
    death: torch.Tensor
    dim: torch.Tensor
    valid: torch.Tensor

    def count(self, k: int) -> torch.Tensor:
        return (self.valid & (self.dim == k)).sum(-1)

    def betti(self, k: int) -> torch.Tensor:
        return (self.valid & (self.dim == k) & torch.isinf(self.death)).sum(-1)

    def finite_birth(self) -> torch.Tensor:
        """Birth with invalid-row NaN sentinels replaced by 0."""
        return torch.where(self.valid, torch.nan_to_num(self.birth), 0.0)

    def finite_death(self, cap: float) -> torch.Tensor:
        """Death with NaN -> 0 and +inf (essential) capped at ``cap``."""
        death = torch.nan_to_num(self.death, nan=0.0, posinf=cap)
        return torch.where(self.valid, death, 0.0)


def pairs_to_diagrams(fc: FilteredComplex, owner: torch.Tensor,
                      positive: torch.Tensor, max_dim: int,
                      sublevel: bool = True) -> Diagrams:
    killed = owner >= 0
    death_val = torch.where(killed,
                            fc.values.gather(1, owner.clamp(min=0).long()),
                            float("inf"))
    birth_val = fc.values
    essential = positive & ~killed & fc.valid
    is_birth = (killed | essential) & fc.valid
    nonzero_pers = ~killed | (death_val != birth_val)
    valid = is_birth & nonzero_pers & (fc.dims <= max_dim) & (fc.dims >= 0)
    sign = 1.0 if sublevel else -1.0
    nan = float("nan")
    birth = torch.where(valid, sign * birth_val, nan)
    death = torch.where(valid, torch.where(torch.isinf(death_val),
                                           float("inf"), sign * death_val),
                        nan)
    return Diagrams(birth=birth, death=death,
                    dim=torch.where(valid, fc.dims, -1), valid=valid)


def persistence_diagrams_batched(g: GraphBatch, max_dim: int = 1,
                                 edge_cap: int = 256, tri_cap: int = 512,
                                 quad_cap: int = 0, sublevel: bool = True,
                                 reducer: str = "blocks") -> Diagrams:
    """Exact PDs of every graph in the batch.

    reducer: ``"blocks"`` (per-dimension blocks, the default) or ``"flat"``
    (one (S, S/32) matrix per graph).  Either runs the ``gf2_reduce``
    kernel on CUDA tensors and the plain version on CPU tensors.
    """
    if reducer not in REDUCERS:
        raise ValueError(f"reducer must be one of {REDUCERS}, got {reducer!r}")
    fc = build_filtered_complex(g.adj, g.mask, g.f, max_dim, edge_cap,
                                tri_cap, quad_cap, sublevel)
    if reducer == "blocks":
        caps = _block_caps(g.n, edge_cap, tri_cap, quad_cap)
        owner, positive = reduce_packed_blocks(fc, caps)
    else:
        (_, owner, positive), = ops.gf2_reduce_blocks([pack_boundary(fc)],
                                                      [fc.size])
    return pairs_to_diagrams(fc, owner, positive, max_dim, sublevel)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def diagrams_bitwise_equal(a, b) -> bool:
    """Bit-identical Diagrams comparison (NaN == NaN on invalid rows).

    Either side may be this package's Diagrams or ``repro``'s: only the
    four fields are read, through numpy.
    """
    return (np.array_equal(_np(a.birth), _np(b.birth), equal_nan=True)
            and np.array_equal(_np(a.death), _np(b.death), equal_nan=True)
            and np.array_equal(_np(a.dim), _np(b.dim))
            and np.array_equal(_np(a.valid), _np(b.valid)))


def diagrams_to_numpy(d: Diagrams, batch_index: int, max_dim: int):
    """{dim: sorted [(birth, death)]} of one graph, as persistence_ref."""
    b = _np(d.birth[batch_index])
    dd = _np(d.death[batch_index])
    dim = _np(d.dim[batch_index])
    val = _np(d.valid[batch_index])
    out = {}
    for k in range(max_dim + 1):
        sel = val & (dim == k)
        out[k] = sorted(zip(b[sel].tolist(), dd[sel].tolist()))
    return out
