"""demo2program_tpu_torch — the PyTorch/CUDA port of demo2program_tpu.

Runs the Karel full model's eval path on an NVIDIA H100: compact batch ->
on-device replay (ops/reconstruct.py) -> FullModel with every LSTM step in
the hand-written CUDA kernel (ops/fused_lstm.py, csrc/fused_lstm.cu) ->
greedy decode -> host syntax/canonical checks -> batched VM execution
accuracy (ops/vm.py, eval/scorer.py).

Each module mirrors the path and names of its JAX counterpart in
demo2program_tpu, which stays the reference. The framework-free layers
(dsl/, envs/, utils/, cli/flags.py, the HDF5 reader data/dataset.py) are
the port's own copies: this package imports nothing of demo2program_tpu,
and torch but never jax, flax, optax, orbax or h5py at import.
"""
