"""reftr_torch.nn (port of reftr_tpu.nn)."""
