"""Entry: the four-stage ``bundle_pipeline`` app on a fleet of robot cells,
from detections JSON files to the written artifacts (BASELINE configs 4
and 5 as one user path).

Traffic: ``fleets`` distinct fleets of ``rigs`` robot cells
(``gen.write_handeye_fleet``: one camera on each flange, ``observations``
gripper poses, ``noise_px`` pixel noise, the cells drawn from the seed and
the fleet's index), with hand-eye and bundle sections: ingest, the
intrinsics stage (Schur LM, K1), the hand-eye stage (planar poses,
Tsai-Lenz, dense LM), the bundle stage seeded by the hand-eye results
(dense LM, camera fixed) and writing. Call i runs ``main`` on fleet i mod
``fleets`` and writes that fleet's artifacts, so the last artifacts of
each fleet are on disk when the window closes.

Judged against the plain reference on every cell of each fleet's last
artifacts (the same inputs give the same artifacts, so a fleet's failures
count for each of its calls):

- ``intr_cost_gap``: the reference's float64 robust cost of each reported
  camera, with each view's pose at its best for that camera, against the
  reference's own minimum over camera and poses, relative.
- ``cost_gap``: the reference's bundle cost at the reported g_se3_c and
  b_se3_t against the reference's bundle minimum, relative; both with the
  reported camera fixed, as the bundle stage fixes it (the camera itself
  is judged by ``intr_cost_gap``).
- ``pose_gap_m`` / ``pose_gap_deg``: the largest translation difference
  and rotation angle of g_se3_c and b_se3_t from that minimum.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench import gen, program
from portbench.reference import bundle, planar
from portbench.reference.geometry import rotation_angle_deg

KEYS = ("fx", "fy", "cx", "cy", "skew")


class Entry:
    spans = (
        ("calibration_tpu_torch.pipeline.loaders:JsonPlanarDatasetLoader.load", "ingest"),
        ("calibration_tpu_torch.pipeline.facades.intrinsics:intrinsics_facade_batch", "schur"),
        ("calibration_tpu_torch.pipeline.fleet:planar_handeye_fleet", "dense"),
        ("calibration_tpu_torch.pipeline.fleet:bundle_fused_fleet", "dense"),
        ("calibration_tpu_torch.native:dumps_fast", "write"),
    )

    def __init__(self, cfg, traffic, seed, device, workdir):
        self.device = device
        self.fleets = int(traffic["fleets"])
        self.rigs = int(traffic["rigs"])
        shape = cfg["shapes"]
        self.huber = float(cfg["pipeline"]["huber_delta"])
        self.inputs = []
        for k in range(self.fleets):
            directory = workdir / f"fleet{k}"
            directory.mkdir()
            fleet = gen.write_handeye_fleet(directory, self.rigs, int(traffic["observations"]), shape["rows"],
                                            shape["cols"], float(traffic["noise_px"]), seed=program.fleet_seed(seed, k))
            fleet["artifacts"] = str(workdir / f"artifacts{k}.json")
            self.inputs.append({key: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
                                for key, v in fleet.items()})
        self.mask = torch.ones(self.inputs[0]["obj"].shape[:3], dtype=torch.float64, device=device)
        self._art = {}
        self._ref = {}

    def call(self, i):
        from calibration_tpu_torch.apps import bundle_pipeline

        k = i % self.fleets
        f = self.inputs[k]
        program.run_main(bundle_pipeline.main, ["--input", f["input_path"], "--output", f["artifacts"],
                                                "--device", self.device])
        self._art.pop(k, None)
        return {"fleet": k}

    def artifacts(self, k):
        """(cameras (R, 10), g_se3_c, b_se3_t (R, 4, 4), ok (R,) bool) of
        fleet k's last artifacts; None where a rig has none."""
        if k not in self._art:
            with open(self.inputs[k]["artifacts"]) as fh:
                art = json.load(fh)
            summary = {s["name"]: s for s in art["pipeline_summary"]["stages"]}
            cams = {c["sensor_id"]: c for c in summary["intrinsics"]["cameras"] if "camera" in c}
            intr, g, b, ok = [], [], [], []
            for r in range(self.rigs):
                cam = cams.get(f"cam{r}")
                rig = art.get("bundle", {}).get(f"rig{r}", {}).get("result")
                if cam is None or rig is None:
                    return None
                intr.append([cam["camera"]["kmtx"][key] for key in KEYS] + cam["camera"]["distortion"]["coeffs"])
                g.append(rig["g_se3_c"][0])
                b.append(rig["b_se3_t"])
                ok.append(cam["optimization"]["success"])
            statuses = [s["status"] == "ok" for s in summary["bundle"]["rigs"]]
            t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device)  # noqa: E731
            self._art[k] = (t(intr), t(g), t(b), np.asarray(ok) & np.asarray(statuses))
        return self._art[k]

    def outcome(self, out):
        art = self.artifacts(out["fleet"])
        return self.rigs, self.rigs if art is None else int((~art[3]).sum())

    def counters(self, kept):
        return {}

    def reference_intrinsics(self, k, dtype=torch.float64):
        """(camera, poses, cost) of fleet k's cameras, solved from the truth
        by the reference in ``dtype``."""
        f = self.inputs[k]
        intr0 = f["intr"].expand(self.rigs, -1)
        return planar.solve(f["obj"], f["uv"], self.mask, intr0, f["ct_gt"], self.huber, dtype=dtype)

    def reference_bundle(self, k, intr, dtype=torch.float64):
        """(g_se3_c, b_se3_t, cost) of fleet k's rigs with the cameras
        ``intr`` (R, 10) fixed, solved from the truth in ``dtype``."""
        f = self.inputs[k]
        return bundle.solve(f["obj"], f["uv"], self.mask, f["bg"], intr, f["g_gt"], f["bt_gt"], self.huber,
                            dtype=dtype)

    def control(self, k):
        """Fleet k's artifacts as the reference in float32 gives them."""
        intr, _, _ = self.reference_intrinsics(k, torch.float32)
        g, b, _ = self.reference_bundle(k, intr, torch.float32)
        self._art[k] = (intr.double(), g.double(), b.double(), np.ones(self.rigs, bool))
        return {"fleet": k}

    def judge(self, kept):
        intr_gap, cost_gap, gap_m, gap_deg = [], [], [], []
        for k in sorted({out["fleet"] for out in kept}):
            art = self.artifacts(k)
            if art is None:
                return {name: float("inf") for name in ("intr_cost_gap", "cost_gap", "pose_gap_m", "pose_gap_deg")}
            intr, g, b, _ = art
            f = self.inputs[k]
            if k not in self._ref:
                self._ref[k] = self.reference_intrinsics(k)[2]
            _, _, best = planar.solve(f["obj"], f["uv"], self.mask, intr, f["ct_gt"], self.huber, intrinsics=False)
            intr_gap.append(((best - self._ref[k]).abs() / self._ref[k]).max())
            ref_g, ref_b, ref_cost = self.reference_bundle(k, intr)
            cost = bundle.cost(f["obj"], f["uv"], self.mask, f["bg"], intr, g, b, self.huber)
            cost_gap.append(((cost - ref_cost).abs() / ref_cost).max())
            for mine, ref in ((g, ref_g), (b, ref_b)):
                gap_m.append((mine[:, :3, 3] - ref[:, :3, 3]).abs().max())
                gap_deg.append(rotation_angle_deg(mine[:, :3, :3], ref[:, :3, :3]).max())
        return {"intr_cost_gap": program.worst(intr_gap), "cost_gap": program.worst(cost_gap),
                "pose_gap_m": program.worst(gap_m), "pose_gap_deg": program.worst(gap_deg)}
