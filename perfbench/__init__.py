"""The benchmark of ``repro_torch``: one command runs one cell once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``README.md`` beside this file for how a cell, a configuration, a
traffic mix and a metric are found by name.
"""
