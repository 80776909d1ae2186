"""demo2program_tpu_torch — the PyTorch/CUDA port of demo2program_tpu.

Trains and evaluates the four model families on Karel and ViZDoom on an
NVIDIA H100, every LSTM step in the hand-written CUDA kernel
(ops/fused_lstm.py, csrc/fused_lstm.cu). Karel: compact batch -> on-device
replay (ops/reconstruct.py) -> model -> decode -> host syntax/canonical
checks -> batched VM execution accuracy (ops/vm.py, eval/scorer.py).
ViZDoom: DoomLite-rendered frames held on the device
(train/device_cache.py) -> 5-conv encoder and model -> decode -> engine
replays of the programs (eval/vizdoom_scorer.py).

Each module mirrors the path and names of its JAX counterpart in
demo2program_tpu, which stays the reference. The framework-free layers
(dsl/, envs/ with DoomLite, utils/, cli/flags.py, the HDF5 readers and
generators under data/) are the port's own copies: this package imports
nothing of demo2program_tpu, and torch but never jax, flax, optax, orbax,
h5py or cv2 at import.
"""
