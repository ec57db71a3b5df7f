"""TiledMatrix (counterpart of ``slate_tpu/core/tiles.py``).

A zero-padded 2D torch tensor plus structure metadata. The padded dims
are multiples of the tile sizes (mb, nb); tiles are a logical indexing
concept. Transposition travels as a flag (``op``) and is materialised
by ``resolve``; ``uplo``/``diag``/``mtype`` tag the structure.

Padding invariant: out-of-range rows/cols of ``data`` are zero.
Routines that need a nonsingular padded diagonal (getrf) patch it to
identity with :func:`pad_diag_identity`.

``sub``/``slice`` are copies of the selected tiles or elements, as the
reference's functional views. Not ported: non-uniform tiles (the
reference's ``rb``/``cb`` boundaries, ``from_func``); ``uniform`` is
therefore the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.backend import DeviceLike, resolve_device
from .enums import Diag, MatrixType, Op, Uplo
from .exceptions import DimensionError, slate_assert


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (x >= 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def _as_tensor(a, device: DeviceLike) -> torch.Tensor:
    """torch tensor on the resolved device (numpy and tensors alike)."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.as_tensor(a, device=dev)


@dataclasses.dataclass(frozen=True)
class TiledMatrix:
    """A tiled, zero-padded matrix.

    data : (m_pad, n_pad) tensor, m_pad = mt*mb, n_pad = nt*nb,
           zero outside [:m, :n]. If ``op != NoTrans`` the stored
           tensor is the un-transposed original; the logical shape is
           (n, m).
    """

    data: torch.Tensor
    m: int
    n: int
    mb: int
    nb: int
    mtype: MatrixType = MatrixType.General
    uplo: Uplo = Uplo.General
    op: Op = Op.NoTrans
    diag: Diag = Diag.NonUnit
    kl: int = -1          # band lower bandwidth (band types only)
    ku: int = -1          # band upper bandwidth

    # -- basic geometry ----------------------------------------------------
    @property
    def mt(self) -> int:
        return self.data.shape[0] // self.mb

    @property
    def nt(self) -> int:
        return self.data.shape[1] // self.nb

    @property
    def shape(self) -> Tuple[int, int]:
        """Logical (op-resolved) shape."""
        if self.op is Op.NoTrans:
            return (self.m, self.n)
        return (self.n, self.m)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_complex(self) -> bool:
        return self.data.is_complex()

    def tileMb(self, i: int) -> int:
        return min(self.mb, self.m - i * self.mb)

    def tileNb(self, j: int) -> int:
        return min(self.nb, self.n - j * self.nb)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dense(cls, a, mb: int = 256, nb: Optional[int] = None,
                   mtype: MatrixType = MatrixType.General,
                   uplo: Uplo = Uplo.General, diag: Diag = Diag.NonUnit,
                   kl: int = -1, ku: int = -1,
                   device: DeviceLike = None) -> "TiledMatrix":
        """Wrap a dense array (numpy or torch), padding to tile
        multiples (reference fromLAPACK). The data goes to `device`,
        CUDA unless the caller names another."""
        a = _as_tensor(a, device)
        if a.ndim != 2:
            raise DimensionError(f"expected 2D, got {tuple(a.shape)}")
        nb = nb or mb
        m, n = a.shape
        mp, np_ = round_up(max(m, 1), mb), round_up(max(n, 1), nb)
        a = torch.nn.functional.pad(a, (0, np_ - n, 0, mp - m))
        return cls(data=a, m=m, n=n, mb=mb, nb=nb, mtype=mtype, uplo=uplo,
                   diag=diag, kl=kl, ku=ku)

    def uniform(self) -> "TiledMatrix":
        """The uniform padded layout the factorization drivers assume:
        every port matrix already has it (non-uniform tiles are not
        ported)."""
        return self

    @classmethod
    def zeros(cls, m: int, n: int, mb: int = 256, nb: Optional[int] = None,
              dtype=torch.float32, device: DeviceLike = None, **kw
              ) -> "TiledMatrix":
        nb = nb or mb
        data = torch.zeros((round_up(max(m, 1), mb),
                            round_up(max(n, 1), nb)),
                           dtype=dtype, device=resolve_device(device))
        return cls(data=data, m=m, n=n, mb=mb, nb=nb, **kw)

    # -- transpose-by-flag -------------------------------------------------
    def transpose(self) -> "TiledMatrix":
        if self.op is Op.ConjTrans:
            return dataclasses.replace(self, data=self.data.conj(),
                                       op=Op.NoTrans)
        new_op = {Op.NoTrans: Op.Trans, Op.Trans: Op.NoTrans}[self.op]
        return dataclasses.replace(self, op=new_op)

    def conj_transpose(self) -> "TiledMatrix":
        if self.op is Op.Trans:
            return dataclasses.replace(self, data=self.data.conj(),
                                       op=Op.NoTrans)
        new = {Op.NoTrans: Op.ConjTrans, Op.ConjTrans: Op.NoTrans}[self.op]
        return dataclasses.replace(self, op=new)

    @property
    def T(self) -> "TiledMatrix":
        return self.transpose()

    @property
    def H(self) -> "TiledMatrix":
        return self.conj_transpose()

    def tile(self, i: int, j: int) -> torch.Tensor:
        """Tile (i, j) of the stored tensor, padding included."""
        return self.data[i * self.mb:(i + 1) * self.mb,
                         j * self.nb:(j + 1) * self.nb]

    def sub(self, i1: int, i2: int, j1: int, j2: int) -> "TiledMatrix":
        """Tile-index submatrix [i1..i2] x [j1..j2] inclusive (reference
        sub()), a General matrix; a transposed view resolves first."""
        base = self if self.op is Op.NoTrans else self.resolve()
        mm = min((i2 + 1) * base.mb, base.m) - i1 * base.mb
        nn = min((j2 + 1) * base.nb, base.n) - j1 * base.nb
        data = base.data[i1 * base.mb:(i2 + 1) * base.mb,
                         j1 * base.nb:(j2 + 1) * base.nb]
        return dataclasses.replace(base, data=data, m=mm, n=nn,
                                   mtype=MatrixType.General,
                                   uplo=Uplo.General)

    def slice(self, row1: int, row2: int, col1: int, col2: int
              ) -> "TiledMatrix":
        """Element-index submatrix [row1..row2] x [col1..col2] inclusive
        (reference slice()), re-tiled from element 0, structure flags
        kept; a structured slice must be diagonal-aligned."""
        r = self.resolve()
        if r.mtype is not MatrixType.General:
            slate_assert(row1 == col1,
                         "slice of structured matrix must be "
                         "diagonal-aligned (row1 == col1)")
        d = r.data[:r.m, :r.n][row1:row2 + 1, col1:col2 + 1]
        return TiledMatrix.from_dense(d, r.mb, r.nb, mtype=r.mtype,
                                      uplo=r.uplo, diag=r.diag, kl=r.kl,
                                      ku=r.ku, device=d.device)

    # -- densification -----------------------------------------------------
    def resolve(self) -> "TiledMatrix":
        """Materialise the op flag into the data. A transposed Lower
        triangular view resolves to an Upper triangular matrix."""
        if self.op is Op.NoTrans:
            return self
        d = self.data.T
        if self.op is Op.ConjTrans:
            d = d.conj()
        return dataclasses.replace(
            self, data=d.contiguous(), m=self.n, n=self.m, mb=self.nb,
            nb=self.mb, op=Op.NoTrans, uplo=self.uplo.flip(), kl=self.ku,
            ku=self.kl)

    def to_dense(self) -> torch.Tensor:
        """The logical matrix as a dense tensor: applies op, mirrors
        symmetric/Hermitian triangles, zeroes the unstored triangle of
        triangular/trapezoid types, applies unit diagonals and band
        masks."""
        r = self.resolve()
        a = r.data[:r.m, :r.n]
        mt = self.mtype
        if mt in (MatrixType.Symmetric, MatrixType.Hermitian,
                  MatrixType.HermitianBand):
            tri = a.tril() if r.uplo is Uplo.Lower else a.triu()
            other = tri.T if mt is MatrixType.Symmetric else tri.T.conj()
            d = tri.diagonal()
            if mt is not MatrixType.Symmetric:
                d = d.real.to(a.dtype)
            a = tri + other - torch.diag(d)
        elif mt in (MatrixType.Triangular, MatrixType.Trapezoid,
                    MatrixType.TriangularBand):
            a = a.tril() if r.uplo is Uplo.Lower else a.triu()
            if r.diag is Diag.Unit:
                a.diagonal().fill_(1)
        if mt in (MatrixType.GeneralBand, MatrixType.TriangularBand,
                  MatrixType.HermitianBand):
            kl = r.kl if r.kl >= 0 else r.m
            ku = r.ku if r.ku >= 0 else r.n
            if mt is MatrixType.HermitianBand:
                kl = ku = max(kl, ku)
            ii = torch.arange(r.m, device=a.device)[:, None]
            jj = torch.arange(r.n, device=a.device)[None, :]
            a = torch.where((jj - ii <= ku) & (ii - jj <= kl), a,
                            torch.zeros((), dtype=a.dtype,
                                        device=a.device))
        return a

    def to_numpy(self):
        return self.to_dense().cpu().numpy()

    def __repr__(self) -> str:
        return (f"TiledMatrix({self.shape[0]}x{self.shape[1]}, "
                f"tiles {self.mb}x{self.nb}, {self.mtype.name}, "
                f"uplo={self.uplo.name}, op={self.op.name}, "
                f"dtype={self.data.dtype}, device={self.data.device})")


def pad_diag_identity(data: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Set the padded part of the diagonal to 1 so padded triangular
    solves and factorizations stay nonsingular. data is (m_pad, n_pad),
    logical (m, n). Returns a new tensor when it changes anything; the
    input is never written."""
    mp, np_ = data.shape
    if min(mp, np_) <= min(m, n):
        return data
    out = data.clone()
    out.diagonal()[min(m, n):].fill_(1)
    return out
