"""The Karel grid world (the port's copy of demo2program_tpu/envs/karel.py,
numpy only)."""
