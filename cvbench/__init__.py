"""The benchmark of controlvar_tpu_torch (`python3 cvbench/run.py --help`)."""
