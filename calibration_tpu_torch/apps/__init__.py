"""CLI entry points of the port, the counterparts of ``calibration_tpu.apps``
(so far ``planar_intrinsics``, ``homography``, ``intrinsic_extrinsic_pipeline``,
``calibration_pipeline`` and ``bundle_pipeline`` without its bundle stage).
Run as ``python -m calibration_tpu_torch.apps.<name>``.
"""
