"""Distributed (slab and pencil) FFTs over mesh axes.

Counterpart of msm_tpu/parallel/pfft.py: the grid's leading spatial axis
(a slab) or its two leading ones (a pencil, 3-D grids) are sharded over
mesh axes, and a d-dim ortho FFT is local `torch.fft` passes between
`Mesh.all_to_all` relayouts, with JAX's layouts:

  slab   real space (.., Z/n, Y, X)   -> k space (.., Z, Y/n, X)
  pencil real space (.., Z/px, Y/py, X) -> k space (.., Z, Y/px, X/py)

Forward transforms return k space in the transposed distribution and the
inverses take it, so a k-space round trip costs two all_to_alls on a slab
and four on a pencil. k is in natural order, as everywhere in the port.
Leading (stream batch) axes pass through; 1-D grids are never spatially
sharded.
"""

from __future__ import annotations

import torch


def canonical_shard_axis(dims: int) -> int:
    """Array axis (negative) sharded in real space."""
    return -dims


def transposed_shard_axis(dims: int) -> int:
    """Array axis (negative) sharded in k space (transposed layout)."""
    return -dims + 1


def fftn_sharded(x: torch.Tensor, dims: int, mesh, axes) -> torch.Tensor:
    """Forward ortho FFT on a slab: canonical-sharded in, transposed out."""
    if dims < 2:
        raise ValueError("1-D grids cannot be spatially sharded")
    nd = x.ndim
    x = torch.fft.fftn(x, dim=tuple(range(nd - dims + 1, nd)), norm="ortho")
    x = mesh.all_to_all(x, nd - dims + 1, nd - dims, axes)
    return torch.fft.fft(x, dim=nd - dims, norm="ortho")


def ifftn_sharded(xk: torch.Tensor, dims: int, mesh, axes) -> torch.Tensor:
    """Inverse ortho FFT on a slab: transposed-sharded in, canonical out."""
    if dims < 2:
        raise ValueError("1-D grids cannot be spatially sharded")
    nd = xk.ndim
    x = torch.fft.ifft(xk, dim=nd - dims, norm="ortho")
    x = mesh.all_to_all(x, nd - dims, nd - dims + 1, axes)
    return torch.fft.ifftn(x, dim=tuple(range(nd - dims + 1, nd)), norm="ortho")


def _pencil_axes(dims: int, axes) -> tuple:
    if dims != 3 or len(axes) != 2:
        raise ValueError(f"the pencil decomposition is 3-D over two axes, got {dims}, {axes}")
    return tuple(axes)


def fftn_pencil(x: torch.Tensor, dims: int, mesh, axes) -> torch.Tensor:
    """Forward ortho FFT on a 2-D pencil (px, py) = axes: local X, an
    all_to_all over py (split X, gather Y), local Y, an all_to_all over px
    (split Y, gather Z), local Z."""
    px, py = _pencil_axes(dims, axes)
    nd = x.ndim
    zax, yax, xax = nd - 3, nd - 2, nd - 1
    x = torch.fft.fft(x, dim=xax, norm="ortho")
    x = mesh.all_to_all(x, xax, yax, py)
    x = torch.fft.fft(x, dim=yax, norm="ortho")
    x = mesh.all_to_all(x, yax, zax, px)
    return torch.fft.fft(x, dim=zax, norm="ortho")


def ifftn_pencil(xk: torch.Tensor, dims: int, mesh, axes) -> torch.Tensor:
    """Inverse ortho FFT: transposed k pencil in, real-space pencil out."""
    px, py = _pencil_axes(dims, axes)
    nd = xk.ndim
    zax, yax, xax = nd - 3, nd - 2, nd - 1
    x = torch.fft.ifft(xk, dim=zax, norm="ortho")
    x = mesh.all_to_all(x, zax, yax, px)
    x = torch.fft.ifft(x, dim=yax, norm="ortho")
    x = mesh.all_to_all(x, yax, xax, py)
    return torch.fft.ifft(x, dim=xax, norm="ortho")


def forward(x: torch.Tensor, dims: int, mesh, axes) -> torch.Tensor:
    """The slab transform over one axis, the pencil over two."""
    if len(axes) == 2:
        return fftn_pencil(x, dims, mesh, axes)
    return fftn_sharded(x, dims, mesh, axes)


def inverse(xk: torch.Tensor, dims: int, mesh, axes) -> torch.Tensor:
    if len(axes) == 2:
        return ifftn_pencil(xk, dims, mesh, axes)
    return ifftn_sharded(xk, dims, mesh, axes)
