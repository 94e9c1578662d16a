"""The benchmark of the PyTorch and CUDA port (``calibration_tpu_torch``)
on an NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See ``run.py``."""
