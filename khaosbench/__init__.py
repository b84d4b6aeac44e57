"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
checkpointed stream job on one card, saturated and under chaos.  Run a
cell with ``python khaosbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``."""
