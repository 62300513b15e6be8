"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``run.py``."""
