"""The fused engine over a space-sharded mesh: the port's kernel wrappers
composed with `Mesh.all_to_all` relayouts.

Counterpart of msm_tpu/parallel/pfft_fused.py (`ShardedEngine`), with the
single-device engine's surface (`ops.mxu_fft.SingleEngine`). Every active
space axis is one combined axis of size d (a (px, py) pencil runs the slab
schedule with d = px * py, its ranks in the combined order); N % d == 0.
Distributions of a 3-D batch (B, ...), k in natural order:

  canonical : (Z/d, Y,    X )   psi in real space
  k-layout  : (Z,   Yk/d, Xk)   psik; rank r holds the contiguous k rows
                                [r N/d, (r+1) N/d) of axis Y
  mixed     : (Z,   Yk/d, Xk)   z spatial, (y, x) in k
  gathered  : (Z/d, Yk,   Xk)   (y, x) whole: the plane kernels' home

Axis Z is whole in the k-layout and the mixed distribution, so the column
kernels (K1, K3, K5, K12, K13) run on the shard as on one device, on a
(B, N, N^2/d) operand whose k^2 over the trailing axes is the shard's rows
of the s12 table (`consts.spec_axis12`, sliced by `MeshStepper`), summed
s0 + s12 as the kernels sum them; the plane kernels (K2, K4, K6, K7, K9,
K10, K11) run on the B N/d gathered planes. One all_to_all each way moves a
field between the two. Reductions leave the kernels as per-shard partials
(K1's and K13's sums, K4's and K11's per-plane maxima over the shard's N/d
planes of each stream) and finish over the space group in a fixed order
(`Mesh.psum`, `Mesh.pmax`), so every rank of a stream block carries the
same per-stream scalars and the loop's control stays the same on each.

Relayouts per skewed step: 4 all_to_alls (each a pass of the local
shard), beside the 4 kernels; exact dt's prefix adds 3.
"""

from __future__ import annotations

import torch

from ..ops import mxu_fft as mx


class ShardedEngine:
    """The fused engine on shards of a space-sharded mesh (see the module
    docstring): `mesh` and its combined space `axes`. Its methods take and
    return shard-local tensors; every reduction they return is already
    finished over the space axes."""

    def __init__(self, mesh, axes, dims: int, poisson_coeff: float, alias_cutoff: float,
                 prefactor: float):
        if dims != 3:
            raise ValueError("the sharded fused engine is defined for 3-D grids")
        self.mesh = mesh
        self.axes = tuple(axes)
        self.dims = dims
        self.poisson_coeff = float(poisson_coeff)
        self.alias_cutoff = float(alias_cutoff)
        self.prefactor = float(prefactor)

    # -- relayouts ------------------------------------------------------

    def _to_gathered(self, x):
        """mixed (Z, Yk/d, Xk) -> gathered (Z/d, Yk, Xk): split Z, concat Y."""
        return self.mesh.all_to_all(x, x.ndim - 3, x.ndim - 2, self.axes)

    def _to_mixed(self, x):
        """gathered (Z/d, Yk, Xk) -> mixed (Z, Yk/d, Xk): split Y, concat Z."""
        return self.mesh.all_to_all(x, x.ndim - 2, x.ndim - 3, self.axes)

    # -- reduction finishers ----------------------------------------------

    def _psum(self, x):
        return self.mesh.psum(x, self.axes)

    def _stream_max(self, plane_maxes, b: int):
        """The per-stream maximum of the shard's per-plane maxima (b streams
        of N/d planes each), finished over the space axes."""
        return self.mesh.pmax(plane_maxes.view(b, -1).amax(dim=-1), self.axes)

    # -- transforms -------------------------------------------------------

    def forward(self, psi):
        """canonical psi -> k-layout psik: K6 on the gathered planes, one
        all_to_all, K5 along Z."""
        return mx.axis_pass(self._to_mixed(mx.plane_pass(psi, inverse=False)), 1,
                            inverse=False)

    def inverse(self, psik):
        """k-layout psik -> canonical psi: K5 inverse, one all_to_all, K6
        inverse."""
        return mx.plane_pass(self._to_gathered(mx.axis_pass(psik, 1, inverse=True)),
                             inverse=True)

    def poisson_solve(self, psi, consts):
        """The three-pass solve on shards: K7 (density and its (y, x)
        forward) on the canonical planes, one all_to_all, K3 with the
        shard's s12 rows (the map -coeff/k^2 built in the kernel), one
        all_to_all, K9 (Re of the (y, x) inverse). Returns canonical phi."""
        rho_t = self._to_mixed(mx.plane_density_fwd(psi, self.prefactor))
        phi_t = mx.axis_roundtrip_poisson(rho_t, consts.spec_axis0, consts.spec_axis12,
                                          self.poisson_coeff)
        del rho_t
        return mx.plane_pass_real_inv(self._to_gathered(phi_t))

    # -- fused steps ------------------------------------------------------

    def _interior(self, x, consts, vcoeff):
        """K2, K3, K4 from the mixed distribution: (psi, q, per-plane
        max|phi|), psi and q gathered."""
        psi, rho_t = mx.plane_inv_density(self._to_gathered(x), self.prefactor)
        del x
        rho_t = self._to_mixed(rho_t)
        phi_t = mx.axis_roundtrip_poisson(rho_t, consts.spec_axis0, consts.spec_axis12,
                                          self.poisson_coeff)
        del rho_t
        q, maxes = mx.plane_potkick_fwd(self._to_gathered(phi_t), psi, vcoeff)
        return psi, q, maxes

    def fused_step(self, psik, consts, kick, vcoeff):
        """The unskewed step: K12, K2, K3, K4, K13 and 4 all_to_alls, k-layout
        in and out; `SingleEngine.fused_step`'s contract."""
        b = psik.shape[0]
        x = mx.axis_inv_kick(psik, consts.spec_axis0, consts.spec_axis12, kick)
        psi, q, maxes = self._interior(x, consts, vcoeff)
        psik_new, norm, alias = mx.axis_fwd_reduce(
            self._to_mixed(q), consts.spec_axis0, consts.spec_axis12, self.alias_cutoff
        )
        return psi, psik_new, self._psum(norm), self._psum(alias), self._stream_max(maxes, b)

    def fused_step_skewed(self, q, consts, kick, vcoeff):
        """The skewed step: K1, K2, K3, K4 and 4 all_to_alls on the carrier
        at the mixed distribution; the sums describe the entering state
        (`SingleEngine.fused_step_skewed`)."""
        b = q.shape[0]
        x, norm, alias = mx.axis_roundtrip_kick(
            q, consts.spec_axis0, consts.spec_axis12, kick, self.alias_cutoff
        )
        _psi, q_next, maxes = self._interior(x, consts, vcoeff)
        del _psi
        return (self._to_mixed(q_next), self._psum(norm), self._psum(alias),
                self._stream_max(maxes, b))

    def exact_prefix(self, q, consts, pending):
        """Exact dt's pre-step bound: K1 (no sums), K10, K3, K11 and 3
        all_to_alls; returns (the pending-kicked carrier, max|phi(t)|)."""
        b = q.shape[0]
        q1 = mx.axis_roundtrip_kick(q, consts.spec_axis0, consts.spec_axis12, pending, 0.0,
                                    with_reduce=False)
        rho_t = self._to_mixed(mx.plane_inv_density_rho_only(self._to_gathered(q1),
                                                             self.prefactor))
        phi_t = mx.axis_roundtrip_poisson(rho_t, consts.spec_axis0, consts.spec_axis12,
                                          self.poisson_coeff)
        del rho_t
        return q1, self._stream_max(mx.plane_real_inv_max(self._to_gathered(phi_t)), b)

    def skew_enter(self, psik):
        """k-layout psik -> the carrier (K5 inverse along the whole Z)."""
        return mx.axis_pass(psik, 1, inverse=True)

    def skew_exit(self, q, consts, pending):
        """(psi, psik, norm, alias) from the carrier: K1 with the deferred
        kick and the last step's sums, psik = K5 along Z, psi = K6 inverse
        after one all_to_all."""
        x, norm, alias = mx.axis_roundtrip_kick(
            q, consts.spec_axis0, consts.spec_axis12, pending, self.alias_cutoff
        )
        psik = mx.axis_pass(x, 1, inverse=False)
        psi = mx.plane_pass(self._to_gathered(x), inverse=True)
        return psi, psik, self._psum(norm), self._psum(alias)
