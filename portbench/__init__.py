"""The H100 benchmark of ``pixelnerf_tpu_torch``: ``python portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
