"""reftr_torch.ops (port of reftr_tpu.ops)."""
