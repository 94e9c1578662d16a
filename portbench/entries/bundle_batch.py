"""Entry: ``bundle_batch`` on a fleet of one-camera robot cells held in
memory (BASELINE config 5: hand-eye bundle adjustment, camera fixed).

Traffic: ``fleets`` distinct fleets of ``rigs`` rigs, each the config-5
set (``gen.bundle_problems``: ``observations`` gripper poses, the pixel
noise and the robot motions drawn from the seed and the fleet's index,
g0 and b0 the truth moved by fixed small poses); call i solves fleet
i mod ``fleets`` through the phased dense LM.

Judged against the plain reference (``reference.bundle``), on every rig of
every call of the window:

- ``cost_gap``: the reference's float64 robust cost at the program's
  g_se3_c and b_se3_t against the reference's own minimum, relative.
- ``pose_gap_m``: the largest translation difference of g_se3_c and
  b_se3_t from the reference's minimum, in metres.
- ``pose_gap_deg``: the largest rotation angle between them, in degrees.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen, program
from portbench.reference import bundle
from portbench.reference.geometry import rotation_angle_deg


class Entry:
    spans = (("calibration_tpu_torch.parallel.batched:bundle_batch", "dense"),)

    def __init__(self, cfg, traffic, seed, device, workdir):
        from calibration_tpu_torch.optim import BundleOptions, OptimOptions

        self.device = device
        self.fleets = int(traffic["fleets"])
        self.rigs = int(traffic["rigs"])
        shape = cfg["shapes"]
        solver = cfg["bundle"]
        self.huber = float(solver["huber_delta"])
        self.opts = BundleOptions(core=OptimOptions(
            max_iterations=int(solver["max_iterations"]), huber_delta=self.huber,
            compute_covariance=bool(solver["compute_covariance"])))
        self.problems, self.args = [], []
        for k in range(self.fleets):
            p = gen.bundle_problems(self.rigs, int(traffic["observations"]), shape["rows"], shape["cols"],
                                    float(traffic["noise_px"]), seed=program.fleet_seed(seed, k))
            t = {key: torch.as_tensor(v, device=device) for key, v in p.items()}
            b, o = p["bg"].shape[:2]
            self.problems.append(t)
            self.args.append([t["obj"], t["uv"], t["bg"], torch.zeros((b, o), dtype=torch.int64, device=device),
                              torch.as_tensor(np.tile(p["intr"][None, None], (b, 1, 1)), device=device),
                              t["g0"][:, None].contiguous(), t["b0"]])
        self.mask = torch.ones(self.problems[0]["obj"].shape[:3], dtype=torch.float64, device=device)
        self._ref = {}

    def call(self, i):
        from calibration_tpu_torch.parallel import batched

        k = i % self.fleets
        lm, _, g, b, _, _ = batched.bundle_batch(*self.args[k], opts=self.opts)
        return {"fleet": k, "success": lm.success, "linearizations": lm.linearizations, "g": g[:, 0], "b": b}

    def outcome(self, out):
        return self.rigs, int((~out["success"]).sum())

    def counters(self, kept):
        lin = torch.stack([out["linearizations"] for out in kept]).double()
        return {"dense.linearizations": float(lin.mean())}

    def reference(self, k, dtype=torch.float64):
        """(g_se3_c, b_se3_t, cost) of fleet k, solved from the truth by the
        reference in ``dtype``."""
        p = self.problems[k]
        return bundle.solve(p["obj"], p["uv"], self.mask, p["bg"], p["intr"], p["g_gt"], p["b_gt"], self.huber,
                            dtype=dtype)

    def control(self, k):
        """Fleet k's outputs from the reference in float32."""
        g, b, _ = self.reference(k, torch.float32)
        ok = torch.ones(self.rigs, dtype=torch.bool, device=self.device)
        return {"fleet": k, "success": ok, "linearizations": torch.zeros_like(ok, dtype=torch.int64),
                "g": g.double(), "b": b.double()}

    def judge(self, kept):
        cost_gap, gap_m, gap_deg = [], [], []
        for out in kept:
            k = out["fleet"]
            if k not in self._ref:
                self._ref[k] = self.reference(k)
            ref_g, ref_b, ref_cost = self._ref[k]
            p = self.problems[k]
            cost = bundle.cost(p["obj"], p["uv"], self.mask, p["bg"], p["intr"], out["g"], out["b"], self.huber)
            cost_gap.append(((cost - ref_cost).abs() / ref_cost).max())
            for mine, ref in ((out["g"], ref_g), (out["b"], ref_b)):
                gap_m.append((mine[:, :3, 3] - ref[:, :3, 3]).abs().max())
                gap_deg.append(rotation_angle_deg(mine[:, :3, :3], ref[:, :3, :3]).max())
        return {"cost_gap": program.worst(cost_gap), "pose_gap_m": program.worst(gap_m),
                "pose_gap_deg": program.worst(gap_deg)}
