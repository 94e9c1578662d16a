"""The benchmark's input generators, frozen here.

Copies of ``chip_smoke.py``'s numpy generators (``make_problems``,
``bench_poses``, ``write_fleet`` / ``detections_payload`` /
``write_config``, ``write_handeye_fleet``, ``bundle_problems``), which
restate the reference library's benchmark sets. Two changes only: the
pinhole projection is this module's own numpy code (the same operations in
the same order as the port's ``pinhole.project``, so the outputs are equal),
and every generator takes the seeds of its noise as arguments. The
defaults give ``chip_smoke.py``'s sets; ``portbench/tests`` holds the copies
equal to the originals.

Nothing here imports the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# the bench.py set's camera: [fx, fy, cx, cy, skew, k1, k2, k3, p1, p2]
BENCH_INTR = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 1e-4, -2e-4])
# the benchmark sets' solver camera (bundle, hand-eye)
SOLVER_INTR = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 1e-4, -1e-4])
# the robot-cell pipeline fleet's camera
FLEET_INTR = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 1e-4, -5e-5])


def project(intr, pc):
    """Pinhole Brown-Conrady projection in float64 numpy: camera-frame
    points pc (..., 3) -> pixels (..., 2); intr (..., 10) broadcasts."""
    intr = np.asarray(intr, float)
    x = pc[..., 0] / pc[..., 2]
    y = pc[..., 1] / pc[..., 2]
    k1, k2, k3, p1, p2 = (intr[..., 5 + i] for i in range(5))
    r2 = x * x + y * y
    radial = np.ones_like(r2)
    rpow = r2
    for k in (k1, k2, k3):
        radial = radial + k * rpow
        rpow = rpow * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    u = intr[..., 0] * xd + intr[..., 4] * yd + intr[..., 2]
    v = intr[..., 1] * yd + intr[..., 3]
    return np.stack([u, v], axis=-1)


def exp_so3(w):
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    th = np.where(th < 1e-12, 1.0, th)
    a = w / th
    th = th[..., 0]
    k = np.zeros(w.shape[:-1] + (3, 3))
    k[..., 0, 1], k[..., 0, 2] = -a[..., 2], a[..., 1]
    k[..., 1, 0], k[..., 1, 2] = a[..., 2], -a[..., 0]
    k[..., 2, 0], k[..., 2, 1] = -a[..., 1], a[..., 0]
    return np.eye(3) + np.sin(th)[..., None, None] * k + (1 - np.cos(th))[..., None, None] * (k @ k)


def pose(w, t):
    m = np.eye(4)
    m[:3, :3] = exp_so3(np.asarray(w, float))
    m[:3, 3] = t
    return m


def grid(rows, cols, pitch):
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    obj = np.stack([xs.ravel() * pitch, ys.ravel() * pitch], -1)
    return obj - obj.mean(0)


def render(intr, c_se3_t, obj, noise, rng):
    """Pixels (V, N, 2) of planar points obj (N, 2) seen from poses
    c_se3_t (V, 4, 4), plus Gaussian noise."""
    obj3 = np.concatenate([obj, np.zeros((obj.shape[0], 1))], -1)
    pc = np.einsum("vij,nj->vni", c_se3_t[:, :3, :3], obj3) + c_se3_t[:, None, :3, 3]
    uv = project(intr, pc)
    return uv + rng.normal(0, noise, uv.shape) if noise > 0 else uv


def bench_poses(batch, views=10):
    """The bench.py set's camera poses: (B, V, 4, 4)."""
    ang = 2 * np.pi * np.arange(views)[None, :] / views + 0.05 * np.arange(batch)[:, None]
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], axis=-1)
    t = np.stack([0.06 * np.cos(ang), 0.06 * np.sin(ang), 0.9 + 0.08 * np.sin(ang)], axis=-1)
    poses = np.zeros((batch, views, 4, 4))
    poses[..., :3, :3] = exp_so3(w)
    poses[..., :3, 3] = t
    poses[..., 3, 3] = 1.0
    return poses


def make_problems(batch, views=10, rows=8, cols=11, noise=0.2, seed=7):
    """The bench.py problem set (BASELINE config 2): B cameras, V views of
    a rows x cols grid at 0.03 m, pixel noise drawn from ``seed``. Returns
    (obj (B, V, N, 2), uv (B, V, N, 2), the true camera (10,))."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    obj = grid(rows, cols, 0.03)
    poses = bench_poses(batch, views)
    obj3 = np.concatenate([obj, np.zeros((n, 1))], -1)
    pts_c = np.einsum("bvij,nj->bvni", poses[:, :, :3, :3], obj3) + poses[:, :, None, :3, 3]
    uv = project(BENCH_INTR, pts_c)
    uv = uv + rng.normal(0, noise, uv.shape)
    return np.tile(obj[None, None], (batch, views, 1, 1)), uv, BENCH_INTR.copy()


def detections_payload(sensor_id, obj, uv):
    """A detections JSON payload in the committed format
    (examples/data/detections_cam0.json) for views uv (V, N, 2) of target
    points obj (N, 2)."""
    return {
        "image_directory": "synthetic", "feature_type": "synthetic_grid", "algo_version": "1",
        "params_hash": "synthetic", "sensor_id": sensor_id, "tags": ["synthetic"],
        "metadata": {"detector": {"name": "synthetic_grid"}}, "source_file": "",
        "images": [
            {
                "file": f"{sensor_id}_img_{v:03d}.png",
                "points": [
                    {"x": float(uv[v, j, 0]), "y": float(uv[v, j, 1]), "id": j,
                     "local_x": float(obj[j, 0]), "local_y": float(obj[j, 1]), "local_z": 0.0}
                    for j in range(obj.shape[0])
                ],
            }
            for v in range(uv.shape[0])
        ],
    }


def displace(uv, outliers, seed):
    """In every view of every sensor, ``outliers`` points moved by 20-40 px
    in a random direction, from a generator seeded per sensor ([seed, i]),
    so a sensor's data does not depend on the fleet size. Changes uv in
    place; returns the displaced (B, V, N) bool."""
    b, v, n = uv.shape[:3]
    displaced = np.zeros((b, v, n), bool)
    for i in range(b):
        rng = np.random.default_rng([seed, i])
        for j in range(v):
            pick = rng.choice(n, outliers, replace=False)
            ang = rng.uniform(0, 2 * np.pi, outliers)
            uv[i, j, pick] += rng.uniform(20, 40, outliers)[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
            displaced[i, j, pick] = True
    return displaced


def write_fleet(directory, b, seed=11, outliers=4, noise_seed=7, options=None):
    """The make_problems(b) set (noise from ``noise_seed``) as b detections
    files plus a config listing the b cameras (``write_config``), with
    ``outliers`` points of every view displaced (``displace``, from
    ``seed``). Returns (config path, feature paths, displaced (b, V, N)
    bool, obj, uv)."""
    directory = Path(directory)
    obj, uv, _ = make_problems(b, seed=noise_seed)
    displaced = displace(uv, outliers, seed)
    features = []
    for i in range(b):
        path = directory / f"detections_cam{i:03d}.json"
        path.write_text(json.dumps(detections_payload(f"cam{i:03d}", obj[i, 0], uv[i])))
        features.append(str(path))
    return write_config(directory, b, options), features, displaced, obj, uv


# chip_smoke.write_config's options
FLEET_OPTIONS = {
    "optim_options": {"core": {"max_iterations": 40, "epsilon": 1e-9, "compute_covariance": True}},
    "estim_options": {"homography_ransac": {}},
    "min_corners_per_view": 20,
    "refine": True,
}


def write_config(directory, b, options=None) -> str:
    """A planar-intrinsics config for cameras cam000.. (pinhole, 640 x
    480) with ``options`` (default ``FLEET_OPTIONS``)."""
    config = {
        "algorithm": "planar",
        "options": FLEET_OPTIONS if options is None else options,
        "cameras": [
            {"camera_id": f"cam{i:03d}", "model": "pinhole_brown_conrady", "image_size": [640, 480]}
            for i in range(b)
        ],
    }
    path = Path(directory) / f"config_{b}.json"
    path.write_text(json.dumps(config))
    return str(path)


def handeye_sequence(num_poses, rng, g_se3_c, b_se3_t):
    """``num_poses`` camera views of the target, then the gripper poses
    that give them (base_se3_gripper (P, 4, 4), cam_se3_target (P, 4, 4))."""
    bg, ct = [], []
    for _ in range(num_poses):
        c = pose(rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.08, 0.08, 3) + np.array([0.0, 0.0, 0.7]))
        bg.append(b_se3_t @ np.linalg.inv(c) @ np.linalg.inv(g_se3_c))
        ct.append(c)
    return np.stack(bg), np.stack(ct)


def bundle_problems(batch, num_obs=20, rows=8, cols=11, noise=0.2, seed=19):
    """The bundle benchmark set (BASELINE config 5): B rigs of one camera,
    ``num_obs`` observations of a planar grid with pixel noise, and the
    truth perturbed by fixed small poses as the g0 and b0 seeds. Returns a
    dict of numpy arrays (obj, intr, g_gt, b_gt, bg, uv, g0, b0, ct)."""
    rng = np.random.default_rng(seed)
    obj = grid(rows, cols, 0.03)
    intr = SOLVER_INTR.copy()
    out = {k: [] for k in ("g_gt", "b_gt", "bg", "uv", "g0", "b0", "ct")}
    dp = pose([0.008, -0.006, 0.01], [0.003, -0.002, 0.004])
    dq = pose([-0.005, 0.007, -0.004], [0.002, 0.003, -0.002])
    for i in range(batch):
        g = pose([0.1 + 1e-3 * i, -0.2, 0.15], [0.02, -0.03, 0.05])
        bt = pose([0.05, 0.03, -0.08], [0.4, -0.1, 0.2])
        bg, ct = handeye_sequence(num_obs, rng, g, bt)
        for key, val in (("g_gt", g), ("b_gt", bt), ("bg", bg), ("uv", render(intr, ct, obj, noise, rng)),
                         ("g0", g @ dp), ("b0", bt @ dq), ("ct", ct)):
            out[key].append(val)
    return dict(obj=np.tile(obj[None, None], (batch, num_obs, 1, 1)), intr=intr,
                **{k: np.stack(v) for k, v in out.items()})


def write_handeye_fleet(directory, rigs, num_obs=12, rows=8, cols=11, noise=0.05, seed=29):
    """The robot-cell pipeline fleet: ``rigs`` robot cells, each one camera
    with its own hand-eye transform and base -> target pose and
    ``num_obs`` observations, written as detections files, a
    planar-intrinsics config and a bundle_pipeline input with hand-eye and
    bundle sections (the bundle rigs take the hand-eye rig's observations,
    intrinsics fixed). One generator runs over the rigs in order. Returns
    dict(obj, uv, bg, ct_gt (R, O, ...), intr, g_gt, bt_gt (R, 4, 4),
    input_path)."""
    out = Path(directory)
    rng = np.random.default_rng(seed)
    obj = grid(rows, cols, 0.03)
    n = obj.shape[0]
    intr = FLEET_INTR.copy()
    arrays = {k: np.zeros((rigs, num_obs) + s) for k, s in (("uv", (n, 2)), ("bg", (4, 4)), ("ct_gt", (4, 4)))}
    g_b, bt_b = np.zeros((rigs, 4, 4)), np.zeros((rigs, 4, 4))
    sensors, cameras, he_rigs = [], [], []
    for r in range(rigs):
        sensor = f"cam{r}"
        g = pose(rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.06, 0.06, 3))
        bt = pose(rng.uniform(-0.2, 0.2, 3), [0.4, -0.1, 0.2] + rng.uniform(-0.05, 0.05, 3))
        g_b[r], bt_b[r] = g, bt
        obs = []
        for i in range(num_obs):
            ct = pose(rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.08, 0.08, 3) + [0, 0, 0.8])
            bg = bt @ np.linalg.inv(ct) @ np.linalg.inv(g)
            arrays["uv"][r, i] = render(intr, ct[None], obj, 0.0, rng)[0] + rng.normal(0, noise, (n, 2))
            arrays["bg"][r, i], arrays["ct_gt"][r, i] = bg, ct
            obs.append({"view_id": f"v{i}", "base_se3_gripper": bg.tolist(), "images": {sensor: f"{sensor}_he_{i:03d}.png"}})
        payload = detections_payload(sensor, obj, arrays["uv"][r])
        for i, img in enumerate(payload["images"]):
            img["file"] = f"{sensor}_he_{i:03d}.png"
        (out / f"detections_{sensor}.json").write_text(json.dumps(payload))
        sensors.append({"sensor_id": sensor, "path": f"detections_{sensor}.json"})
        cameras.append({"camera_id": sensor, "model": "pinhole_brown_conrady", "image_size": [640, 480]})
        he_rigs.append({"rig_id": f"rig{r}", "sensors": [sensor], "observations": obs,
                        "options": {"huber_delta": 1.0}, "min_angle_deg": 1.0})
    (out / "planar_intrinsics_config.json").write_text(json.dumps({
        "algorithm": "planar",
        "options": {"optim_options": {"core": {"huber_delta": 1.0, "max_iterations": 200}},
                    "min_corners_per_view": 20, "refine": True},
        "cameras": cameras,
    }))
    bundle_rigs = [
        {"rig_id": f"rig{r}", "sensors": [f"cam{r}"], "options": {"optimize_intrinsics": False}, "min_angle_deg": 1.0}
        for r in range(rigs)
    ]
    input_path = out / "bundle_input.json"
    input_path.write_text(json.dumps({
        "planar_intrinsics_config": "planar_intrinsics_config.json", "planar_detections": sensors,
        "hand_eye": {"rigs": he_rigs}, "bundle": {"rigs": bundle_rigs},
    }))
    return dict(obj=np.tile(obj[None, None], (rigs, num_obs, 1, 1)), **arrays, intr=intr, g_gt=g_b, bt_gt=bt_b,
                input_path=str(input_path))
