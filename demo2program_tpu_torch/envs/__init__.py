"""The Karel grid world, the DoomLite engine and the ViZDoom environment
wrapper (the port's copies of demo2program_tpu/envs, numpy only)."""
