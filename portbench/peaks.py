"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet
of the H100 SXM, dense rates, at its 700 W limit).  A share of a peak is
stated against these, with the card's power limit beside it."""

H100 = {
    "f32_flop_per_s": 67e12,       # float32 outside the tensor cores
    "tf32_flop_per_s": 495e12,
    "bf16_flop_per_s": 989e12,
    "bytes_per_s": 3.35e12,        # HBM3
    "memory_bytes": 80e9,
}
