"""The paper's experiments on the port: Tables 1-7, Table 1b and Figs. 1b,
2 and 3, the counterparts of `benchmarks/common.py`, `benchmarks/tables.py`
and the tables of `benchmarks/run.py`.

    PYTHONPATH=src python -m repro_torch.experiments.run --quick --device cpu
"""
