"""CLI entry points of the port, the counterparts of ``calibration_tpu.apps``
(all six: ``planar_intrinsics``, ``homography``, ``intrinsic_extrinsic_pipeline``,
``calibration_pipeline``, ``bundle_pipeline`` and ``linescan_calibration``).
Run as ``python -m calibration_tpu_torch.apps.<name>``.
"""
