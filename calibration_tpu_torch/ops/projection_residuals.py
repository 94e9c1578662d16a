"""Fused f32 projection residuals and the fleet QA recheck built on them:
the port of the reference's one TPU kernel,
``calibration_tpu/ops/pallas_kernels.py::projection_residuals_f32``, and of
``calibration_tpu/parallel/batched.py::reprojection_rms_batch`` around it.

Per point: R [x, y, 0] + t, the perspective divide, Brown-Conrady (k1, k2,
k3, p1, p2), K (fx, fy, cx, cy, skew), then (u_hat - u, v_hat - v) * mask.
One row is one (problem, view) pair. One CUDA kernel,
``csrc/projection_residuals.cu``, has two modes:

- ``projection_residuals_f32`` (residual mode): (R, N, 2) float32
  residuals, the JAX kernel's function.
- ``projection_rms_f32`` (RMS mode): the (B, V) float32 per-view
  reprojection RMS of the facade's QA recheck in one launch, read in place
  from the caller's (B, V, 4, 4) poses and (B, 10) intrinsics.

On CUDA tensors a wrapper launches the kernel or raises; on CPU tensors it
computes the plain version. The tensor's device decides; there is no
fallback from a failed launch. The plain versions,
``projection_residuals_plain`` and ``projection_rms_plain``, stay here for
the tests and ``chip_smoke.py``. Each launch counts ``k1.launches.rms``
or ``k1.launches.residuals`` (``utils.profiling.counters()``), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build
from ..utils import profiling

_SCALARS = {torch.float32: 0, torch.float64: 1}
_MASKS = {torch.bool: 0, torch.uint8: 0, torch.float32: 1, torch.float64: 2}
_STRIDES = (
    ("rot", "bvij"), ("tra", "bvi"), ("intr", "bvk"), ("obj", "bv"), ("uv", "bv"), ("mask", "bvn"),
)


class LaunchArgs(ctypes.Structure):
    """The kernel's argument struct (``LaunchArgs`` in the CUDA source),
    field for field: pointers, then B, V, N, the strides in elements, and
    the input and mask type codes."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in ("rot", "tra", "intr", "obj", "uv", "mask", "out")]
        + [(name, ctypes.c_int64) for name in ("batch", "views", "points")]
        + [(f"{name}_{axis}", ctypes.c_int64) for name, axes in _STRIDES for axis in axes]
        + [("scalar", ctypes.c_int64), ("mask_kind", ctypes.c_int64)]
    )


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


def _rms_from_residuals(res, mask_r):
    cnt = torch.clamp(torch.sum(mask_r.to(res.dtype), dim=-1), min=1.0)
    return torch.sqrt(torch.sum(res * res, dim=(-2, -1)) / (2.0 * cnt))


def _check_shapes(rot, tra, intr, obj_xy, img_uv, mask):
    """Shapes and devices of rows with leading dims L = obj_xy.shape[:-2]:
    rot L + (3, 3), tra L + (3,), intr L + (10,), obj_xy/img_uv L + (N, 2),
    mask L + (N,)."""
    if obj_xy.dim() < 3 or obj_xy.shape[-1] != 2:
        raise ValueError(f"obj_xy: expected shape (..., N, 2), got {tuple(obj_xy.shape)}")
    lead, n = tuple(obj_xy.shape[:-2]), obj_xy.shape[-2]
    want = {
        "rot": (rot, lead + (3, 3)),
        "tra": (tra, lead + (3,)),
        "intr": (intr, lead + (10,)),
        "img_uv": (img_uv, lead + (n, 2)),
        "mask": (mask, lead + (n,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != obj_xy.device:
            raise ValueError(f"{name} is on {t.device}, obj_xy on {obj_xy.device}")


def _rms_views(c_se3_t, intrs, obj_xy, img_uv, mask):
    """RMS mode's inputs as (B, V, ...) rows: views of the caller's
    tensors, no copies."""
    if obj_xy.dim() != 4:
        raise ValueError(f"obj_xy: expected shape (B, V, N, 2), got {tuple(obj_xy.shape)}")
    b, v = obj_xy.shape[0], obj_xy.shape[1]
    for name, t, shape in (("c_se3_t", c_se3_t, (b, v, 4, 4)), ("intrs", intrs, (b, 10))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    return c_se3_t[..., :3, :3], c_se3_t[..., :3, 3], intrs[:, None, :].expand(b, v, 10), obj_xy, img_uv, mask


def launch_args(rot, tra, intr, obj_xy, img_uv, mask, out) -> LaunchArgs:
    """The kernel's arguments for inputs viewed as (B, V, ...) rows: rot
    (B, V, 3, 3), tra (B, V, 3), intr (B, V, 10), obj_xy/img_uv (B, V, N, 2),
    mask (B, V, N); out (B, V, N, 2) or (B, V) float32, contiguous. Each
    pointer is the tensor's own ``data_ptr()`` and each stride its own, so
    nothing is copied. Raises ValueError on what the kernel does not take:
    another device, a dtype outside float32/float64 (one for rot, tra,
    intr and the points) or bool/uint8/float32/float64 (mask), points whose
    (x, y) pairs are not contiguous and aligned for one 2-element load."""
    _check_shapes(rot, tra, intr, obj_xy, img_uv, mask)
    if obj_xy.dim() != 4:
        raise ValueError(f"obj_xy: expected shape (B, V, N, 2), got {tuple(obj_xy.shape)}")
    b, v, n = obj_xy.shape[:3]
    if b * v >= 2**31 or n >= 2**31:
        raise ValueError(f"{b * v} rows of {n} points: the kernel indexes rows and points with 32 bits")
    dtype = obj_xy.dtype
    if dtype not in _SCALARS or any(t.dtype != dtype for t in (rot, tra, intr, img_uv)):
        raise ValueError(
            "rot, tra, intr, obj_xy and img_uv must share one dtype, float32 or float64; got "
            f"{[str(t.dtype) for t in (rot, tra, intr, obj_xy, img_uv)]}"
        )
    if mask.dtype not in _MASKS:
        raise ValueError(f"mask: dtype {mask.dtype} is not bool, uint8, float32 or float64")
    for name, t in (("obj_xy", obj_xy), ("img_uv", img_uv)):
        pair = 2 * t.element_size()
        if t.stride(3) != 1 or t.stride(2) != 2 or t.stride(0) % 2 or t.stride(1) % 2 or t.data_ptr() % pair:
            raise ValueError(f"{name}: each (x, y) pair must be contiguous and {pair}-byte aligned")
    if out.dtype != torch.float32 or not out.is_contiguous() or tuple(out.shape) not in ((b, v, n, 2), (b, v)):
        raise ValueError(f"out: expected contiguous float32 (B, V, N, 2) or (B, V), got {tuple(out.shape)}")
    if out.device != obj_xy.device:
        raise ValueError(f"out is on {out.device}, obj_xy on {obj_xy.device}")
    tensors = {"rot": rot, "tra": tra, "intr": intr, "obj": obj_xy, "uv": img_uv, "mask": mask}
    strides = {
        f"{name}_{axis}": stride
        for name, axes in _STRIDES
        for axis, stride in zip(axes, tensors[name].stride())
    }
    return LaunchArgs(
        **{name: t.data_ptr() for name, t in tensors.items()}, out=out.data_ptr(),
        batch=b, views=v, points=n, **strides, scalar=_SCALARS[dtype], mask_kind=_MASKS[mask.dtype],
    )


def _launch(mode: str, views, out) -> None:
    """Launch ``mode`` ("residuals" or "rms") on the (B, V, ...) rows
    ``views`` into ``out``, on the current stream of their device."""
    device = out.device
    if device.type != "cuda":
        raise ValueError(f"projection kernel: no kernel for device {device}")
    args = launch_args(*views, out)
    lib = _build.load_library()
    fn = lib.projection_rms_launch if mode == "rms" else lib.projection_residuals_launch
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"projection kernel ({mode} mode) launch failed: CUDA error {err}")
    profiling.count(f"k1.launches.{mode}")


def projection_residuals_f32(rot, tra, intr, obj_xy, img_uv, mask):
    """Fused masked reprojection residuals, float32 (R, N, 2).

    rot (R, 3, 3); tra (R, 3); intr (R, 10); obj_xy/img_uv (R, N, 2); mask
    (R, N); R = flattened problems x views. On the CPU the inputs are cast
    to float32, as the reference dispatcher casts them, and the plain
    version runs; on the card the kernel reads float32 or float64 inputs in
    place and rounds each value to float32 in registers.
    """
    _check_shapes(rot, tra, intr, obj_xy, img_uv, mask)
    if obj_xy.device.type == "cpu":
        return projection_residuals_plain(
            *(t.to(torch.float32).contiguous() for t in (rot, tra, intr, obj_xy, img_uv, mask))
        )
    r, n = obj_xy.shape[0], obj_xy.shape[1]
    out = torch.empty((r, n, 2), dtype=torch.float32, device=obj_xy.device)
    if out.numel() == 0:
        return out
    _launch("residuals", [t.unsqueeze(1) for t in (rot, tra, intr, obj_xy, img_uv, mask)], out.unsqueeze(1))
    return out


def projection_rms_plain(c_se3_t, intrs, obj_xy, img_uv, mask):
    """The plain RMS: float32 casts of the rows, ``projection_residuals_plain``,
    then sqrt(sum(r^2) / (2 max(sum(mask), 1))) per row. (B, V) float32."""
    views = _rms_views(c_se3_t, intrs, obj_xy, img_uv, mask)
    _check_shapes(*views)
    b, v, n = obj_xy.shape[0], obj_xy.shape[1], obj_xy.shape[2]
    rot, tra, intr, obj, uv, mask_r = (
        t.reshape(b * v, *t.shape[2:]).to(torch.float32).contiguous() for t in views
    )
    return _rms_from_residuals(projection_residuals_plain(rot, tra, intr, obj, uv, mask_r), mask_r).reshape(b, v)


def projection_rms_f32(c_se3_t, intrs, obj_xy, img_uv, mask):
    """Per-view reprojection RMS in pixels, float32 (B, V), in one launch.

    c_se3_t (B, V, 4, 4); intrs (B, 10), shared by a camera's views;
    obj_xy/img_uv (B, V, N, 2); mask (B, V, N). On the CPU this is the plain
    RMS; on the card the kernel reads the caller's tensors in place (no
    cast, no copy of the poses, no broadcast of the intrinsics).
    """
    if obj_xy.device.type == "cpu":
        return projection_rms_plain(c_se3_t, intrs, obj_xy, img_uv, mask)
    views = _rms_views(c_se3_t, intrs, obj_xy, img_uv, mask)
    out = torch.empty(obj_xy.shape[:2], dtype=torch.float32, device=obj_xy.device)
    if out.numel() == 0:
        return out
    _launch("rms", views, out)
    return out
