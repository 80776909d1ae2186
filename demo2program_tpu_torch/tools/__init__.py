"""Offline tools over the evaler's dumps (`python -m
demo2program_tpu_torch.tools.<name>`)."""
