"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

H100 = dict(
    bf16_flop_per_s=989e12,
    tf32_flop_per_s=495e12,
    f32_flop_per_s=67e12,
    hbm_bytes_per_s=3.35e12,
)


def matmul_peak(precision, tf32_enabled):
    """The peak FLOP/s of a configuration's stated compute precision: bf16,
    or f32 (TF32's where the run finds TF32 enabled for matmuls)."""
    if precision == "bf16":
        return H100["bf16_flop_per_s"]
    if precision == "f32":
        return H100["tf32_flop_per_s" if tf32_enabled else "f32_flop_per_s"]
    raise ValueError(f"no peak for precision {precision!r}")
