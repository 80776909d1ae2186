"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit)."""

BF16_FLOPS = 989e12   # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12   # TF32 tensor cores: the rate of float32 operands
HBM_BYTES = 3.35e12   # HBM3 bytes/s

# the denominator of every model-FLOP share, whatever the dtype, so that a
# share can never pass 100%
MFU_PEAK = BF16_FLOPS

# the peak of an LSTM step's operands, by dtype name
LSTM_PEAK = {"float32": TF32_FLOPS, "bfloat16": BF16_FLOPS}
