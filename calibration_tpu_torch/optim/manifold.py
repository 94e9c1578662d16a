"""Product manifolds for LM parameter blocks (port of
``calibration_tpu/optim/manifold.py``).

The ambient parameter vector stays flat; steps live in the tangent space
and map back by ``retract``. A quaternion block is 4 ambient / 3 tangent
(``ceres::QuaternionManifold``). Fixed coordinates are the LM engine's
free-mask, not the manifold's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops import se3

Block = Tuple[str, int]  # ("euclid", n) or ("quat", 4)


def euclid(n: int) -> Block:
    return ("euclid", n)


def quat() -> Block:
    return ("quat", 4)


class ProductManifold:
    """Static block structure. Methods broadcast over leading batch dims."""

    def __init__(self, blocks: Sequence[Block]):
        self.blocks = tuple(blocks)
        self.ambient_dim = 0
        self.tangent_dim = 0
        self._segments = []  # (kind, amb_slice, tan_slice)
        for kind, n in self.blocks:
            if kind == "euclid":
                a, t = n, n
            elif kind == "quat":
                a, t = 4, 3
            else:
                raise ValueError(f"unknown block kind {kind}")
            self._segments.append(
                (kind, slice(self.ambient_dim, self.ambient_dim + a),
                 slice(self.tangent_dim, self.tangent_dim + t))
            )
            self.ambient_dim += a
            self.tangent_dim += t
        # consecutive blocks of one kind, retracted together: (kind, count,
        # amb_slice, tan_slice)
        self._runs = []
        for kind, sa, st in self._segments:
            if self._runs and self._runs[-1][0] == kind:
                _, count, ra, rt = self._runs[-1]
                self._runs[-1] = (kind, count + 1, slice(ra.start, sa.stop), slice(rt.start, st.stop))
            else:
                self._runs.append((kind, 1, sa, st))

    def retract(self, x, delta):
        """x_ambient (+) delta_tangent -> x_ambient. Each run of consecutive
        blocks of one kind is retracted by one set of operations (the same
        arithmetic per block): under forward-mode autodiff every operation
        costs host time, and a rig or a camera has tens of quaternion
        blocks."""
        parts = []
        for kind, count, sa, st in self._runs:
            if kind == "euclid":
                parts.append(x[..., sa] + delta[..., st])
            else:  # quat: right-multiply the local exp, normalized
                lead = x.shape[:-1]
                q = x[..., sa].reshape(lead + (count, 4))
                qn = se3.quat_mul(q, se3.exp_quat(delta[..., st].reshape(delta.shape[:-1] + (count, 3))))
                parts.append((qn / torch.linalg.norm(qn, dim=-1, keepdim=True)).reshape(qn.shape[:-2] + (4 * count,)))
        return torch.cat(parts, dim=-1)

    def lift_jacobian(self, x):
        """d retract / d delta at delta = 0: (..., ambient_dim, tangent_dim),
        in closed form. For a quaternion block it is 0.5 [q]_L[:, 1:] / |q|:
        exp_quat has derivative [0; I/2] at zero, and the normalization's
        projection drops nothing because q (x) [0, v] is orthogonal to q."""
        lead = x.shape[:-1]
        d = torch.zeros(lead + (self.ambient_dim, self.tangent_dim), dtype=x.dtype, device=x.device)
        for kind, sa, st in self._segments:
            if kind == "euclid":
                d[..., sa, st] = torch.eye(sa.stop - sa.start, dtype=x.dtype, device=x.device)
            else:
                q = x[..., sa]
                w, qx, qy, qz = q.unbind(-1)
                cols = torch.stack(
                    [
                        torch.stack([-qx, w, qz, -qy], -1),
                        torch.stack([-qy, -qz, w, qx], -1),
                        torch.stack([-qz, qy, -qx, w], -1),
                    ],
                    dim=-1,
                )  # (..., 4, 3)
                d[..., sa, st] = 0.5 * cols / torch.linalg.norm(q, dim=-1)[..., None, None]
        return d

    def ambient_to_tangent_mask(self, amb_mask):
        """Map an ambient free-mask to tangent dims (quat: any-of-4 -> 3)."""
        parts = []
        for kind, sa, st in self._segments:
            if kind == "euclid":
                parts.append(amb_mask[..., sa])
            else:
                any_free = torch.any(amb_mask[..., sa], dim=-1, keepdim=True)
                parts.append(any_free.expand(amb_mask.shape[:-1] + (3,)))
        return torch.cat(parts, dim=-1)
