"""Fused f32 projection residuals: the port of the reference's one TPU
kernel, ``calibration_tpu/ops/pallas_kernels.py::projection_residuals_f32``.

Per point: R [x, y, 0] + t, the perspective divide, Brown-Conrady (k1, k2,
k3, p1, p2), K (fx, fy, cx, cy, skew), then (u_hat - u, v_hat - v) * mask.
One row is one (problem, view) pair.

- ``projection_residuals_f32`` is the wrapper. On CUDA tensors it launches
  the hand-written kernel ``csrc/projection_residuals.cu`` or raises; on CPU
  tensors it computes the plain version. The tensor's device decides; there
  is no fallback from a failed launch.
- ``projection_residuals_plain`` is the plain PyTorch version, computed in
  the dtype it is given (float64 inputs give the exact-math oracle).
- ``launches`` counts kernel launches, so a run can show that its main path
  went through the kernel.
"""

from __future__ import annotations

import torch

from ..kernels import _build

launches = 0


def projection_residuals_plain(rot, tra, intr, obj_xy, img_uv, mask):
    """rot (R, 3, 3); tra (R, 3); intr (R, 10); obj_xy/img_uv (R, N, 2);
    mask (R, N). Returns (R, N, 2) residuals in the inputs' dtype, with the
    kernel's operation order (inverse depth, then multiply)."""
    ox, oy = obj_xy[..., 0], obj_xy[..., 1]

    def col(a, i):
        return a[:, i, None]  # (R, 1), broadcast over the points

    r = rot.reshape(-1, 9)
    xc = col(r, 0) * ox + col(r, 1) * oy + col(tra, 0)
    yc = col(r, 3) * ox + col(r, 4) * oy + col(tra, 1)
    zc = col(r, 6) * ox + col(r, 7) * oy + col(tra, 2)
    inv_z = 1.0 / zc
    xn = xc * inv_z
    yn = yc * inv_z
    r2 = xn * xn + yn * yn
    k1, k2, k3, p1, p2 = (col(intr, 5 + i) for i in range(5))
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    fx, fy, cx, cy, skew = (col(intr, i) for i in range(5))
    upred = fx * xd + skew * yd + cx
    vpred = fy * yd + cy
    m = mask.to(upred.dtype)
    return torch.stack([(upred - img_uv[..., 0]) * m, (vpred - img_uv[..., 1]) * m], dim=-1)


def _check_shapes(rot, tra, intr, obj_xy, img_uv, mask):
    r, n = obj_xy.shape[0], obj_xy.shape[1]
    want = {
        "rot": (rot, (r, 3, 3)),
        "tra": (tra, (r, 3)),
        "intr": (intr, (r, 10)),
        "obj_xy": (obj_xy, (r, n, 2)),
        "img_uv": (img_uv, (r, n, 2)),
        "mask": (mask, (r, n)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != obj_xy.device:
            raise ValueError(f"{name} is on {t.device}, obj_xy on {obj_xy.device}")


def projection_residuals_f32(rot, tra, intr, obj_xy, img_uv, mask):
    """Fused masked reprojection residuals, float32 (R, N, 2).

    Inputs are cast to contiguous float32, as the reference dispatcher
    casts them; R = flattened problems x views.
    """
    global launches
    _check_shapes(rot, tra, intr, obj_xy, img_uv, mask)
    rot, tra, intr, obj_xy, img_uv, mask = (
        t.to(torch.float32).contiguous() for t in (rot, tra, intr, obj_xy, img_uv, mask)
    )
    if obj_xy.device.type == "cpu":
        return projection_residuals_plain(rot, tra, intr, obj_xy, img_uv, mask)
    if obj_xy.device.type != "cuda":
        raise ValueError(f"projection_residuals_f32: no kernel for device {obj_xy.device}")

    r, n = obj_xy.shape[0], obj_xy.shape[1]
    out = torch.empty((r, n, 2), dtype=torch.float32, device=obj_xy.device)
    if r == 0 or n == 0:
        return out
    for name, t in (("obj_xy", obj_xy), ("img_uv", img_uv), ("out", out)):
        if t.data_ptr() % 8:  # the kernel reads and writes float2
            raise ValueError(f"{name} is not 8-byte aligned")
    lib = _build.load_library()
    with torch.cuda.device(obj_xy.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.projection_residuals_f32_launch(
            rot.data_ptr(), tra.data_ptr(), intr.data_ptr(), obj_xy.data_ptr(),
            img_uv.data_ptr(), mask.data_ptr(), out.data_ptr(), r, n, stream,
        )
    if err != 0:
        raise RuntimeError(f"projection_residuals_f32 launch failed: CUDA error {err}")
    launches += 1
    return out
