"""The benchmark of ams_tpu_torch on one H100: ``python3 perfbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
