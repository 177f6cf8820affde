"""Published peaks of the cards the benchmark knows, by
``torch.cuda.get_device_name()``: NVIDIA's H100 SXM data sheet, dense rates
without sparsity, at the full 700 W power limit.  A card missing here gets
no roofline or mfu reading."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12, "f32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}
