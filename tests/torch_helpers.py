"""Shared pieces of the PyTorch-port equivalence tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU in float64, the port on CPU tensors. Importing this module
imports no JAX (``camera_views`` imports the JAX-based ``synth`` when
called), so the card-only tests use it too.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from calibration_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers: keep each one's torch
    intra-op pool to one thread so they do not oversubscribe the host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def k1_launches() -> dict:
    """K1's launches so far by mode, from the program's counter store."""
    c = profiling.counters()
    return {"residuals": c.get("k1.launches.residuals", 0), "rms": c.get("k1.launches.rms", 0)}


def ransac_rounds(device_type: str) -> int:
    """RANSAC rounds run so far on ``device_type``, from the counter store."""
    return profiling.counters().get(f"ransac.rounds.{device_type}", 0)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def camera_views(b, v, rows=5, cols=7, pitch=0.04, noise=0.0, seed=5):
    """B cameras x V views of a planar grid: (obj (B, V, N, 2), uv, poses
    (B, V, 4, 4), intr_gt (10,)). Each camera sees a differently tilted
    circle of views, so lanes converge at different iterations."""
    import synth

    rng = np.random.default_rng(seed)
    intr_gt = synth.default_camera()
    grid = synth.make_target_grid(rows, cols, pitch)
    poses = np.stack([synth.circle_views(v, tilt=0.22 + 0.03 * i) for i in range(b)])
    uv = np.stack([synth.render_pixels(intr_gt, poses[i], grid, noise=noise, rng=rng) for i in range(b)])
    obj = np.broadcast_to(grid, (b, v) + grid.shape).copy()
    return obj, uv, poses, intr_gt


def rel_fro(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report_tolerance(path: str):
    """(rtol, atol) for a float at a report path, or None where floats must
    be equal: linear-stage values 1e-9 relative, the refined camera 1e-6
    relative, the refined extrinsics' cameras and poses 1e-6 relative with
    a 1e-9 absolute floor (pose entries near zero), the final cost 1e-7
    relative, per-view reprojection errors 1e-8 px; the refined hand-eye
    pose 1e-6 relative with a 1e-9 absolute floor and its covariance 1e-6
    relative with a 1e-12 absolute floor; the bundle result's cameras and
    poses as the hand-eye pose, its averaged initial target 1e-9 relative
    with a 1e-12 absolute floor; the line-scan artifact's plane, homography
    and RMS 1e-9 relative with a 1e-12 absolute floor."""
    leaf = path.rsplit("/", 1)[-1]
    if path.startswith(("/plane/n[", "/homography[")) or path in ("/plane/d", "/rms_error"):
        return 1e-9, 1e-12  # the line-scan artifact
    if "initial_guess" in path or "linear_kmtx" in path or "symmetric_rms_px" in path:
        return 1e-9, 0.0
    if "/initial_target[" in path:
        return 1e-9, 1e-12
    if re.search(r"/(optimization|result)/(cameras|c_se3_r|r_se3_t|b_se3_t)\[", path) or "/g_se3_c[" in path:
        return 1e-6, 1e-9
    if "/covariance[" in path:
        return 1e-6, 1e-12
    if "/camera/" in path or "/camera[" in path:
        return 1e-6, 0.0
    if leaf == "final_cost":
        return 1e-7, 0.0
    if leaf in ("rms_px", "global_rms_px") or "view_errors" in path:
        return 0.0, 1e-8
    return None


def _report_numbers(text):
    """The numbers of an LM brief report, and its text without them."""
    pattern = r"[-+]?\d+\.\d+e[-+]\d+|\b\d+\b"
    return [float(x) for x in re.findall(pattern, text)], re.sub(pattern, "#", text)


def assert_reports_match(want, got, path=""):
    """Recursive report comparison: the same keys at every level, equal
    non-floats, floats within ``report_tolerance``, and LM report strings
    equal up to their numbers, which agree to their printed precision."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), (path, sorted(set(want) ^ set(got)))
        for k in want:
            assert_reports_match(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_reports_match(w, g, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        tol = report_tolerance(path)
        assert isinstance(got, float), path
        if tol is None:
            assert got == want, (path, want, got)
        else:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1], err_msg=path)
    elif isinstance(want, str) and (
        path.endswith(("/optimization/report", "/result/report"))
        or ("hand_eye" in path or "sensor_reports" in path) and path.endswith("/report")
    ):
        (wn, wt), (gn, gt) = _report_numbers(want), _report_numbers(got)
        assert wt == gt, (path, want, got)
        np.testing.assert_allclose(gn, wn, rtol=1e-6, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, want, got)
